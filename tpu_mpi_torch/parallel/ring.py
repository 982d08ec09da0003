"""Ring attention: exact attention over sequence shards — the port of
``tpu_mpi/parallel/ring.py``.

Each rank of the ``sp`` mesh axis holds one block of the sequence; the JAX
function rotates the K/V blocks around the axis with ``lax.ppermute`` and
folds them into an online softmax. Here the n ranks share one card and the
blocks are stacked, rank axis first, ``(n, b, h, t, d)`` (on a mesh of
several axes, the other rank dims join the batch); the whole ring is
one launch of the ring-attention kernel
(:mod:`tpu_mpi_torch.kernels.attention`) on a CUDA tensor, at every n,
n = 1 included, and its plain schedule on a CPU tensor.

Rounding follows the Pallas kernel, not ``tpu_mpi/parallel/ring.py``: the
scale multiplies float32 scores (the JAX function pre-scales q in its
dtype), masked keys are -inf (it adds -1e30 and zeroes p below -5e29), and
its n = 1 branch is a plain softmax in the input dtype. The two compute the
same function and are held to a tolerance, not to bits.

The function is differentiable: a ``torch.autograd.Function`` whose
backward is ``attention.attention_backward`` (matmuls recomputing P for
each query block; the JAX package's gradient is XLA's autodiff of its
ring, with no kernel of its own).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import attention as _attention
from ..xla.collectives import Layout, _layout_shape


class _RingAttention(torch.autograd.Function):
    """Kernel (or plain schedule) forward, matmul backward, on stacked
    contiguous (n, BH, t, d) blocks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out = _attention.attend(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        grads = _attention.attention_backward(q, k, v, out, dout.contiguous(),
                                              causal=ctx.causal, scale=ctx.scale)
        return (*grads, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis: str = "sp", mesh: Layout = None, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise-exact attention over a sequence-sharded axis.

    q, k, v: stacked (n, batch, heads, block_len, head_dim) — rank r's
    local sequence block is row r, and it holds global block r; with
    ``mesh=``, (*mesh sizes, batch, heads, block_len, head_dim) and the
    ring runs along ``axis``, the other rank dims riding in the batch.
    Returns the stacked local output blocks (same shape as q); gradients
    flow back to q, k and v in their own shapes. ``axis`` names the mesh
    axis, as in the JAX signature."""
    if not isinstance(axis, str):
        raise ValueError("ring attention runs over one mesh axis")
    order = (axis,) if mesh is None else tuple(_layout_shape(mesh))
    if q.dim() != len(order) + 4 or axis not in order:
        raise ValueError(f"ring_attention takes stacked (*ranks, b, h, t, d) "
                         f"blocks along {axis!r}, got shape {tuple(q.shape)}")
    return attend_along(q, k, v, order.index(axis), causal=causal, scale=scale)


def attend_along(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dim: int, *,
                 causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over the rank dim ``dim`` of q, k, v (..., t, d):
    that dim leads, every other dim before (t, d) joins the batch, and one
    kernel launch serves them all."""
    n, t, d = q.shape[dim], q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    flat = [x.movedim(dim, 0).reshape(n, -1, t, d).contiguous() for x in (q, k, v)]
    out = _RingAttention.apply(*flat, bool(causal), scale)
    front = q.movedim(dim, 0).shape
    return out.view(front).movedim(0, dim)
