"""Ulysses-style sequence parallelism: the head <-> sequence reshard — the
port of ``tpu_mpi/parallel/ulysses.py``.

One ``xla.alltoall`` flips which dimension is sharded: sequence-sharded
activations become head-sharded for exact local attention, then flip
back. On a CUDA tensor each reshard is one launch of the pairwise
all-to-all kernel (:mod:`tpu_mpi_torch.kernels.permute`). Tensors are
stacked, rank axis first (on a mesh of several axes, ``mesh=`` names the
rank dims). The local attention stays plain PyTorch
(``matmul``, ``softmax``), as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch

from .. import xla
from ..xla.collectives import Layout


def seq_to_heads(x: torch.Tensor, *, axis: str = "sp",
                 mesh: Layout = None) -> torch.Tensor:
    """(n, b, h, t/n, d) sequence-sharded -> (n, b, h/n, t, d) head-sharded
    (with ``mesh=``, the rank dims are the mesh's and ``axis`` one of them)."""
    return xla.alltoall(x, axis=axis, mesh=mesh, split_axis=1, concat_axis=2,
                        tiled=True)


def heads_to_seq(x: torch.Tensor, *, axis: str = "sp",
                 mesh: Layout = None) -> torch.Tensor:
    """(n, b, h/n, t, d) head-sharded -> (n, b, h, t/n, d) sequence-sharded."""
    return xla.alltoall(x, axis=axis, mesh=mesh, split_axis=2, concat_axis=1,
                        tiled=True)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis: str = "sp", mesh: Layout = None,
                      causal: bool = True) -> torch.Tensor:
    """Exact attention for sequence-sharded q/k/v via the head reshard."""
    qh = seq_to_heads(q, axis=axis, mesh=mesh)
    kh = seq_to_heads(k, axis=axis, mesh=mesh)
    vh = seq_to_heads(v, axis=axis, mesh=mesh)
    d = qh.shape[-1]
    s = torch.matmul(qh * d ** -0.5, kh.transpose(-1, -2))
    if causal:
        t = s.shape[-1]
        mask = torch.ones((t, t), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, -1e30)
    o = torch.matmul(torch.softmax(s, dim=-1), vh)
    return heads_to_seq(o, axis=axis, mesh=mesh)
