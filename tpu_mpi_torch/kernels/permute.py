"""Collective permute and pairwise all-to-all of n ranks on one card: the
port of the Pallas kernels ``collective_permute`` and ``pairwise_alltoall``
of ``tpu_mpi/xla/pallas_kernels.py``.

Both take the stacked per-rank tensor, rank axis first, ``(n, ...)`` on one
device, and return the stacked per-rank results:

- ``collective_permute(xs, perm)`` -> same shape: rank r's row goes to rank
  ``perm[r]``; ``perm`` must be a permutation of ``0..n-1``, as the TPU
  wrapper demands. ``permute_rows(xs, src)`` is the same kernel driven by a
  per-destination source table where -1 gives a row of zeros: the partial
  pairs of ``xla.sendrecv`` (non-periodic halo edges).
- ``pairwise_alltoall(xs)`` -> ``(n, numel)``: rank s's tensor, flattened,
  is n blocks in destination order, and rank d's result holds the blocks
  every rank sent it in source order, ``out[d, s] = xs[s, d]`` blockwise
  (the flat contract of the TPU wrapper).

On a CUDA tensor each wrapper launches its hand-written kernel in
``tpu_mpi_torch/csrc/permute.cu`` or raises. On a CPU tensor it runs the
plain version beside it, which replays the TPU kernel's puts on the stacked
tensor; that plain version is also the kernel's oracle on the card. Both
move bytes and take every dtype. No hop or semaphore carries over: the TPU
kernels' handshakes guard remote DMA, which does not exist between the
rows of one tensor.

Bound on the card: bytes, 2 x the stacked tensor (each byte read once and
written once). At the recipes' sizes (an 8 MiB pipeline hop) the kernel
takes a few microseconds, so the wrapper's host time decides a call: a
source table is checked and converted to its C array once per distinct
table (a bounded cache), and the launch goes through ``_build.call``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence

import torch

from . import _build
from .ring import _kernel_input, block_elems, stacked_ranks

SOURCE = _build.CSRC / "permute.cu"
REPLACES = {
    "pairwise_alltoall": "tpu_mpi/xla/pallas_kernels.py:390",
    "collective_permute": "tpu_mpi/xla/pallas_kernels.py:463",
}
MAX_RANKS = 512     # TMT_MAX_RANKS: the source table rides as a kernel parameter
TABLE_CACHE = 64    # distinct source tables kept checked and converted

# Launches of each kernel, one per wrapper call that launched it.
launches = dict.fromkeys(REPLACES, 0)
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def _ranks_fit(n: int, what: str) -> None:
    if n > MAX_RANKS:
        raise ValueError(f"{what} kernel takes at most {MAX_RANKS} ranks, got {n}")


# ---------------------------------------------------------------------------
# collective_permute
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=TABLE_CACHE)
def _table(src: tuple, n: int) -> tuple:
    """The checked source table of n destinations and its C array."""
    src = tuple(int(s) for s in src)
    if len(src) != n or any(s < -1 or s >= n for s in src):
        raise ValueError(f"source table {list(src)} does not name one of {n} ranks "
                         f"(or -1) for each of {n} destinations")
    return src, (ctypes.c_int * n)(*src)


@functools.lru_cache(maxsize=TABLE_CACHE)
def _inverse_table(perm: tuple, n: int) -> tuple:
    """``_table`` of the source table of the full permutation ``perm``."""
    return _table(tuple(inverse(perm, n)), n)


def permute_rows_plain(xs: torch.Tensor, src: Sequence[int]) -> torch.Tensor:
    """The TPU kernel's puts on the stacked tensor: rank ``src[d]`` puts its
    row into rank d's; a rank nobody puts to keeps zeros."""
    out = torch.zeros_like(xs, memory_format=torch.contiguous_format)
    for d, s in enumerate(src):
        if s >= 0:
            out[d] = xs[s]
    return out


def _permute(xs: torch.Tensor, n: int, src: tuple, table) -> torch.Tensor:
    # is_cuda and is_contiguous read flags of the tensor: the kernel's path
    # asks nothing more of it
    if not (xs.is_cuda and xs.is_contiguous()):
        if xs.device.type == "cpu":
            return permute_rows_plain(xs, src)
        _kernel_input(xs, "collective_permute")
    _ranks_fit(n, "collective_permute")
    out = torch.empty_like(xs)
    _build.call(LIBRARY.fn("tmt_permute"), xs.device, "collective_permute",
                xs.data_ptr(), out.data_ptr(), n, xs.numel() // n * xs.element_size(),
                table)
    _count("collective_permute")
    return out


def permute_rows(xs: torch.Tensor, src: Sequence[int]) -> torch.Tensor:
    """``out[d] = xs[src[d]]``, zeros where ``src[d]`` is -1."""
    n = stacked_ranks(xs, "collective_permute")
    return _permute(xs, n, *_table(tuple(src), n))


def inverse(perm: Sequence[int], n: int) -> list:
    """The source table of a full permutation (``ValueError`` if ``perm`` is
    not a permutation of ``0..n-1``, as the TPU wrapper raises)."""
    perm = tuple(int(p) for p in perm)
    if sorted(perm) != list(range(n)):
        raise ValueError(f"perm {perm} is not a permutation of 0..{n - 1}")
    src = [0] * n
    for r, p in enumerate(perm):
        src[p] = r
    return src


def collective_permute(xs: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """Rank r's row of the stacked tensor goes to rank ``perm[r]``."""
    n = stacked_ranks(xs, "collective_permute")
    return _permute(xs, n, *_inverse_table(tuple(perm), n))


# ---------------------------------------------------------------------------
# pairwise_alltoall
# ---------------------------------------------------------------------------

def pairwise_alltoall_plain(xs: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's puts: every rank places its own block, then at
    distance k = 1..n-1 rank s puts its block for rank (s+k) % n into that
    rank's slot s."""
    n = xs.shape[0]
    per = block_elems(xs[0].numel(), n)
    blocks = xs.reshape(n, n, per)
    out = torch.empty_like(blocks)
    ranks = torch.arange(n, device=xs.device)
    for k in range(n):
        dst = (ranks + k) % n
        out[dst, ranks] = blocks[ranks, dst]
    return out.reshape(n, n * per)


def pairwise_alltoall(xs: torch.Tensor) -> torch.Tensor:
    """All-to-all of the stacked per-rank tensor ``xs`` (n, ...), each
    rank's size divisible by n: the (n, numel) result's row d holds block d
    of every rank, in source order. One rank returns ``xs`` flattened, as
    the TPU wrapper does."""
    n = stacked_ranks(xs, "pairwise_alltoall")
    per = block_elems(xs[0].numel(), n)
    if n == 1:
        return xs.reshape(1, -1)
    if xs.device.type == "cpu":
        return pairwise_alltoall_plain(xs)
    _kernel_input(xs, "pairwise_alltoall")
    _ranks_fit(n, "pairwise_alltoall")
    out = xs.new_empty((n, n * per))
    _build.call(LIBRARY.fn("tmt_alltoall"), xs.device, "pairwise_alltoall",
                xs.data_ptr(), out.data_ptr(), n, per * xs.element_size())
    _count("pairwise_alltoall")
    return out


# ---------------------------------------------------------------------------
# Library
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tmt_permute.argtypes = [p, p, i, i64, ctypes.POINTER(ctypes.c_int), p]
    lib.tmt_alltoall.argtypes = [p, p, i, i64, p]
    for fn in (lib.tmt_permute, lib.tmt_alltoall):
        fn.restype = ctypes.c_int


LIBRARY = _build.Library("permute", SOURCE, _bind)
