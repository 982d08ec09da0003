"""Tensor (model) parallelism: Megatron-style sharded matmuls — the port
of ``tpu_mpi/parallel/tp.py``.

Column-parallel layers shard the output feature dim (no forward
communication); row-parallel layers shard the input feature dim and sum
the partial products over the ``tp`` axis. Megatron's conjugate pair
carries the gradients, as ``torch.autograd.Function``s:

- ``f`` (:func:`tp_identity_fwd_psum_bwd`): replicates an activation to
  the n ranks forward; backward, the rank-ordered sum of the n cotangent
  rows;
- ``g`` (:func:`tp_psum_fwd_identity_bwd`): the rank-ordered sum of the n
  partial products forward; backward, the cotangent broadcast to every
  rank.

Both sums are ``xla.allreduce``, which on a CUDA tensor is the fused fold
kernel. The n ranks share one card, so per-rank tensors are stacked, rank
axis first, and weight shards are ``(n, d_in, d_out / n)`` /
``(n, d_in / n, d_out)``, as ``shard_params`` of
:mod:`tpu_mpi_torch.models.transformer` cuts them. A replicated activation
(what is the same on every tp rank in the JAX package) is held once,
without a tp rank axis: replication belongs to f and g, so that autograd
never sums rank copies of it a second time.

On a mesh of several axes, tp is a sub-axis: an activation held once over
tp keeps the rank dims of the other axes in front of its local dims, f puts
the tp rank dim ahead of them all, and g folds it away again, one fold
launch for every group. A weight shard may carry the same rank dims after
its tp dim, ``(n, *other rank dims, d_in, d_out / n)`` (per-rank copies,
to take per-rank gradients); a matmul pairs each rank's activation with
its own weight.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import xla
from ..operators import SUM


def _replicate(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.unsqueeze(0).expand((n,) + tuple(x.shape))


class _IdentityPsum(torch.autograd.Function):
    """f: replicate forward (a stride-0 view), rank-ordered sum backward."""

    @staticmethod
    def forward(ctx, x, n, axis):
        ctx.axis = axis
        return _replicate(x, n)

    @staticmethod
    def backward(ctx, g):
        return xla.allreduce(g, SUM, axis=ctx.axis)[0], None, None


class _PsumIdentity(torch.autograd.Function):
    """g: rank-ordered sum forward, broadcast backward."""

    @staticmethod
    def forward(ctx, xs, axis):
        ctx.n = xs.shape[0]
        return xla.allreduce(xs, SUM, axis=axis)[0]

    @staticmethod
    def backward(ctx, g):
        return _replicate(g, ctx.n), None


def tp_identity_fwd_psum_bwd(x: torch.Tensor, axis: str = "tp", *,
                             n: int) -> torch.Tensor:
    """Megatron's ``f``: ``x`` (held once) replicated to the stacked
    (n, *x.shape) forward, the rank-ordered sum of the cotangent rows
    backward — placed where a replicated activation enters a
    column-parallel layer."""
    return _IdentityPsum.apply(x, int(n), axis)


def tp_psum_fwd_identity_bwd(xs: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """Megatron's ``g``: the rank-ordered sum of the stacked (n, ...) rows
    forward (held once), the cotangent broadcast to every rank backward —
    placed where row-parallel partial sums are combined."""
    return _PsumIdentity.apply(xs, axis)


def _per_rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each rank's x times its own w: w (*R, d_in, d_out) with R its rank
    dims, x (*R, ..., d_in) with the same leading dims."""
    ranks = tuple(w.shape[:-2])
    y = torch.matmul(x.reshape((math.prod(ranks), -1, x.shape[-1])),
                     w.reshape((-1,) + tuple(w.shape[-2:])))
    return y.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard: Optional[torch.Tensor] = None,
                    axis: str = "tp") -> torch.Tensor:
    """y_shard = f(x) @ W_shard: ``x`` (..., d_in) held once, output
    features sharded, no forward communication. Returns the stacked
    (n, ..., d_out / n)."""
    n = w_shard.shape[0]
    y = _per_rank_matmul(tp_identity_fwd_psum_bwd(x, axis, n=n), w_shard)
    if b_shard is None:
        return y
    lead = b_shard.dim() - 1
    return y + b_shard.view(tuple(b_shard.shape[:lead]) + (1,) * (y.dim() - lead - 1)
                            + (y.shape[-1],))


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 axis: str = "tp") -> torch.Tensor:
    """y = g(x_shard @ W_shard): input features sharded, the partial
    products summed over ``axis`` in rank order. Returns y (..., d_out),
    the same on every rank, held once."""
    y = tp_psum_fwd_identity_bwd(_per_rank_matmul(x_shard, w_shard), axis)
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
