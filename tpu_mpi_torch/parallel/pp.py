"""Pipeline parallelism: microbatch rotation between stage neighbours —
the port of ``tpu_mpi/parallel/pp.py``.

Stages live on the ranks of a ``pp`` mesh axis; activations advance one
stage per tick in a GPipe schedule. Each tick's hop is ``xla.ring_shift``,
so on a CUDA tensor it is one launch of the collective permute kernel
(:mod:`tpu_mpi_torch.kernels.permute`), for every group the other mesh
axes hold. Tensors are stacked, rank axis first (with ``mesh=``, one rank
dim per mesh axis). The whole schedule is differentiable: gradients ride
the reverse permutation (the permute kernel with the inverse table).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .. import xla
from ..xla.collectives import Layout, _layout_shape


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     params: Any, microbatches: torch.Tensor, *,
                     axis: str = "pp", mesh: Layout = None) -> torch.Tensor:
    """Run microbatches through a chain of stages.

    stage_fn(params, x): every rank's stage at once, on the stacked
    activations x with the stacked per-stage params (each rank's slice is
    its stage's own).

    - Without ``mesh``: x and the params' leaves are (n, ...);
      microbatches (m, ...), injected by rank 0; returns the stacked
      (n, m, ...) emissions of every rank.
    - With ``mesh`` (a mesh or ``{axis: size}`` layout of the leading rank
      dims): x and the params' leaves are (*mesh sizes, ...); microbatches
      (*mesh sizes, m, ...), every rank's own, of which those of the ranks
      at position 0 of ``axis`` are injected; returns (*mesh sizes, m, ...).

    The last stage's emissions are the pipeline's results (the others' are
    what those stages emitted at the same ticks, as in the JAX package)."""
    if mesh is None:
        n, dim, k = _ranks(params), 0, 0
        carry = microbatches.new_zeros((n,) + tuple(microbatches.shape[1:]))
    else:
        shape = _layout_shape(mesh)
        n, dim, k = shape[axis], tuple(shape).index(axis), len(shape)
        carry = torch.zeros_like(microbatches.select(k, 0))
    m = microbatches.shape[k]
    outs = []
    for tick in range(m + n - 1):
        # the ranks at pp position 0 inject a fresh microbatch while any remain
        if tick < m:
            mb = microbatches.select(k, tick)
            inject = (mb[None] if mesh is None else mb).narrow(dim, 0, 1)
        else:
            inject = torch.zeros_like(carry.narrow(dim, 0, 1))
        x = torch.cat([inject, carry.narrow(dim, 1, n - 1)], dim=dim)
        y = stage_fn(params, x)
        # the last stage emits microbatch (tick - (n-1)) at this tick
        outs.append(y)
        carry = xla.ring_shift(y, axis=axis, mesh=mesh, shift=1)
    return torch.stack(outs[n - 1:n - 1 + m], dim=1 if mesh is None else k)


def _ranks(params: Any) -> int:
    """The rank count: the leading dim of the stacked stage params."""
    leaves = _leaves(params)
    if not leaves:
        raise ValueError("pipeline_forward needs stacked stage params")
    n = leaves[0].shape[0]
    if any(t.shape[0] != n for t in leaves):
        raise ValueError("stage params disagree on the rank count")
    return n


def _leaves(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []
