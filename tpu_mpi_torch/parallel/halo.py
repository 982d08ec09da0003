"""Halo exchange: boundary-slice trading along one mesh axis — the port of
``tpu_mpi/parallel/halo.py``.

Two neighbour exchanges per grid dimension (one per direction) move the
boundary slices: ``xla.ring_shift`` when periodic, ``xla.sendrecv`` with
zeros at the edges when not (the PROC_NULL analog). On a CUDA tensor each
is one launch of the collective permute kernel
(:mod:`tpu_mpi_torch.kernels.permute`). Tensors are stacked, rank axis
first. One mesh axis is carried; several wait for the multi-axis mesh.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from .. import xla
from ..xla.mesh import _TOPOLOGY


def halo_exchange(x: torch.Tensor, *, axes: Union[str, Sequence[str]],
                  halo: int = 1, periodic: bool = True) -> torch.Tensor:
    """Pad the last local dim of every rank's block with its neighbours'
    boundaries.

    x: stacked (n, ..., w) local blocks along one mesh axis. Returns the
    stacked (n, ..., w + 2*halo): rank r's block between the last ``halo``
    slices of rank r-1 and the first of rank r+1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) != 1:
        raise NotImplementedError(_TOPOLOGY)
    axis = axes[0]
    n = x.shape[0]
    dim = x.dim() - 1
    lo = x.narrow(dim, 0, halo)                               # my low edge
    hi = x.narrow(dim, x.shape[dim] - halo, halo)             # my high edge
    if periodic:
        from_prev = xla.ring_shift(hi, axis=axis, shift=1)    # prev rank's high edge
        from_next = xla.ring_shift(lo, axis=axis, shift=-1)   # next rank's low edge
    else:
        from_prev = xla.sendrecv(hi, axis=axis,
                                 dest=[i + 1 if i + 1 < n else None for i in range(n)])
        from_next = xla.sendrecv(lo, axis=axis,
                                 dest=[i - 1 if i > 0 else None for i in range(n)])
    return torch.cat([from_prev, x, from_next], dim=dim)
