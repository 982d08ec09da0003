"""Tensor (model) parallelism: Megatron-style sharded matmuls, forward
only — the port of the forward half of ``tpu_mpi/parallel/tp.py``.

Column-parallel layers shard the output feature dim (no communication);
row-parallel layers shard the input feature dim and sum the partial
products over the ``tp`` axis with ``xla.allreduce``, which on a CUDA
tensor is the fused fold kernel. The n ranks share one card, so every
tensor is stacked, rank axis first: ``x`` is ``(n, ..., d_in)`` (a
replicated activation may be an expanded view) and weight shards are
``(n, d_in, d_out / n)`` / ``(n, d_in / n, d_out)``, as
``shard_params`` of :mod:`tpu_mpi_torch.models.transformer` cuts them.

The JAX package's f/g operators (identity forward with psum backward, and
the reverse) only matter for gradients; they become
``torch.autograd.Function``s with the training slice. Until then these
functions compute the forward and carry no backward of their own.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import xla
from ..operators import SUM


def _per_rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n = w.shape[0]
    lead = x.shape[1:-1]
    y = torch.matmul(x.reshape(n, -1, x.shape[-1]), w)
    return y.reshape((n,) + tuple(lead) + (w.shape[-1],))


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard: Optional[torch.Tensor] = None,
                    axis: str = "tp") -> torch.Tensor:
    """y_shard = x @ W_shard on every rank: output features sharded, no
    forward communication. Returns the stacked (n, ..., d_out / n)."""
    y = _per_rank_matmul(x, w_shard)
    if b_shard is None:
        return y
    return y + b_shard.view((y.shape[0],) + (1,) * (y.dim() - 2) + (y.shape[-1],))


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 axis: str = "tp") -> torch.Tensor:
    """y = psum(x_shard @ W_shard): input features sharded, the partial
    products summed over ``axis`` in rank order. Returns the stacked
    (n, ..., d_out), every row the same sum."""
    partial = _per_rank_matmul(x_shard, w_shard)
    y = xla.allreduce(partial, SUM, axis=axis)
    return y + b if b is not None else y


def all_gather_output(y_shard: torch.Tensor, axis: str = "tp",
                      dim: int = -1) -> torch.Tensor:
    """Materialize a column-parallel output fully (e.g. for logits):
    every rank gets the shards concatenated along ``dim`` of the local
    shape."""
    if dim < 0:
        dim = y_shard.dim() - 1 + dim
    gathered = xla.allgather(y_shard, axis=axis)        # (n, n, *local)
    return gathered.movedim(1, 1 + dim).flatten(1 + dim, 2 + dim)
