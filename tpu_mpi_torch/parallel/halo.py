"""Halo exchange: boundary-slice trading on a process grid — the port of
``tpu_mpi/parallel/halo.py``.

Two neighbour exchanges per grid dimension (one per direction) move the
boundary slices: ``xla.ring_shift`` when periodic, ``xla.sendrecv`` with
zeros at the edges when not (the PROC_NULL analog). On a CUDA tensor each
is one launch of the collective permute kernel
(:mod:`tpu_mpi_torch.kernels.permute`), for every group the other axes
hold. Tensors are stacked: rank axis first for one axis, or with
``mesh=`` one rank dim per mesh axis.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from .. import xla
from ..xla.collectives import Layout


def halo_exchange(x: torch.Tensor, *, axes: Union[str, Sequence[str]],
                  halo: int = 1, periodic: bool = True,
                  mesh: Layout = None) -> torch.Tensor:
    """Pad each spatial dim of every rank's block with its neighbours'
    boundaries.

    x: stacked local blocks whose last ``len(axes)`` dims are the spatial
    dims, one per mesh axis in ``axes`` — (n, ..., w) along one axis, or
    with ``mesh=`` (*mesh sizes, ..., w_0, w_1, ...). Returns the blocks
    padded by ``halo`` on both sides of each exchanged dim: along an axis,
    rank r's block between the last ``halo`` slices of rank r-1 and the
    first of rank r+1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if mesh is None and len(axes) != 1:
        raise ValueError(f"halo_exchange over the axes {axes} needs mesh=")
    offset = x.dim() - len(axes)
    for j, axis in enumerate(axes):
        dim = offset + j
        n = x.shape[0] if mesh is None else xla.size(mesh, axis)
        lo = x.narrow(dim, 0, halo)                               # my low edge
        hi = x.narrow(dim, x.shape[dim] - halo, halo)             # my high edge
        if periodic:
            from_prev = xla.ring_shift(hi, axis=axis, mesh=mesh, shift=1)
            from_next = xla.ring_shift(lo, axis=axis, mesh=mesh, shift=-1)
        else:
            from_prev = xla.sendrecv(hi, axis=axis, mesh=mesh,
                                     dest=[i + 1 if i + 1 < n else None
                                           for i in range(n)])
            from_next = xla.sendrecv(lo, axis=axis, mesh=mesh,
                                     dest=[i - 1 if i > 0 else None
                                           for i in range(n)])
        x = torch.cat([from_prev, x, from_next], dim=dim)
    return x
