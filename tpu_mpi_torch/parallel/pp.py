"""Pipeline parallelism: microbatch rotation between stage neighbours,
forward — the port of ``tpu_mpi/parallel/pp.py``.

Stages live on the ranks of a ``pp`` mesh axis; activations advance one
stage per tick in a GPipe schedule. Each tick's hop is ``xla.ring_shift``,
so on a CUDA tensor it is one launch of the collective permute kernel
(:mod:`tpu_mpi_torch.kernels.permute`). Tensors are stacked, rank axis
first. The backward rides the reverse permutation with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .. import xla


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     params: Any, microbatches: torch.Tensor, *,
                     axis: str = "pp") -> torch.Tensor:
    """Run microbatches through a chain of stages.

    stage_fn(params, x): every rank's stage at once, on the stacked
    activations x (n, ...) with the stacked per-stage params (rank r's
    slice is stage r's own). microbatches: (m, ...) — only rank 0 injects
    them. Returns the stacked (n, m, ...) emissions of every rank; the last
    rank's are the pipeline's results (the others' are what those stages
    emitted at the same ticks, as in the JAX package)."""
    if not isinstance(axis, str):
        raise NotImplementedError("the pipeline runs over one mesh axis")
    n = _ranks(params)
    m = microbatches.shape[0]
    carry = microbatches.new_zeros((n,) + tuple(microbatches.shape[1:]))
    outs = []
    for tick in range(m + n - 1):
        # rank 0 injects a fresh microbatch while any remain
        inject = microbatches[tick] if tick < m else torch.zeros_like(microbatches[0])
        x = torch.cat([inject[None], carry[1:]])
        y = stage_fn(params, x)
        # the last stage emits microbatch (tick - (n-1)) at this tick
        outs.append(y)
        carry = xla.ring_shift(y, axis=axis, shift=1)
    return torch.stack(outs[n - 1:n - 1 + m], dim=1)


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
