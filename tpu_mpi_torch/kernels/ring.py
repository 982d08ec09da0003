"""Ring collectives of n ranks on one card: the port of the Pallas kernels
``ring_allreduce``, ``ring_reduce_scatter`` and ``ring_allgather`` of
``tpu_mpi/xla/pallas_kernels.py``.

Every function takes the stacked per-rank tensor, rank axis first,
``(n, *local_shape)`` on one device — what ``shard_map(..., in_specs=P("x"))``
hands the TPU kernel, reshaped to ``(n, ...)`` — and returns the stacked
per-rank results:

- ``ring_allreduce(xs, op)`` -> ``(n, *local_shape)``, every row the same;
- ``ring_reduce_scatter(xs, op)`` -> ``(n, per)``: a rank's tensor holds
  ``n`` blocks of ``per`` elements and rank c gets reduced block c;
- ``ring_allgather(xs)`` -> ``(n, n, *local_shape)``: every rank gets all
  ``n`` rows in rank order.

**Fold order.** The TPU kernels do not compute the rank-ordered left fold.
``ring_allreduce`` cuts a rank's tensor into n ring chunks (the padded
``(rows, 128)`` layout of ``_tile_rows``) and folds chunk c in ring order
from rank c: ``x[c-1] ⊕ (… ⊕ (x[c+1] ⊕ x[c]))``, with ``⊕(own, incoming)``.
``ring_reduce_scatter`` folds block c from rank c+1. Floats differ from the
left fold in the last bits, so these are kernels of their own, not the
fused fold of :mod:`tpu_mpi_torch.kernels.fused_reduce`.

On a CUDA tensor each wrapper launches its hand-written kernel in
``tpu_mpi_torch/csrc/ring.cu`` or raises. On a CPU tensor it runs the plain
version beside it, which replays the TPU kernel's step schedule on the
stacked tensor: the n-1 reduce-scatter hops with ``combine(own,
incoming)``, then the n-1 copy hops, over the same chunk layout. The plain
version is also the kernel's oracle on the card. A Python callable ``op``
cannot enter a kernel: decided up front from the op's type, it runs the
plain schedule on any device and is counted in ``callable_rings``.

Bound on the card: bytes. On one card the ring's hops would only copy each
chunk through the same HBM again, so each kernel computes in one pass what
the hops leave on every rank (see the source for the traffic of each). The
reduce-scatter kernel has two routes, chosen from alignment and n and
counted in ``route_launches``: "staged" stages each tile's n slices in
shared memory with bulk asynchronous copies (16-byte-aligned bases, blocks
of whole 16-byte words, an n that :func:`staged_tile` stages), "direct"
loads straight from HBM (any other call).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Callable, Optional

import torch

from . import _build
from .fold_ops import DTYPE_CODE, OP_CODE, PLAIN_STEP, supports
from ..operators import _PREDEFINED, _signed, as_op

SOURCE = _build.CSRC / "ring.cu"
REPLACES = {
    "ring_allreduce": "tpu_mpi/xla/pallas_kernels.py:254",
    "ring_reduce_scatter": "tpu_mpi/xla/pallas_kernels.py:321",
    "ring_allgather": "tpu_mpi/xla/pallas_kernels.py:169",
}

LANE = 128      # the TPU layout's lane width: ring chunks are whole rows of it
SUBLANE = 8     # rows per chunk are a multiple of this

# Launches of each kernel, one per wrapper call that launched it (and of
# the reduce-scatter kernel by route); and ring calls whose op could not
# enter a kernel and ran the plain schedule.
launches = dict.fromkeys(REPLACES, 0)
ROUTES = ("staged", "direct")      # the reduce-scatter kernel's routes
route_launches = dict.fromkeys(ROUTES, 0)
callable_rings = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global callable_rings
    with _count_lock:
        for table in (launches, route_launches):
            for name in table:
                table[name] = 0
        callable_rings = 0


def _count(name: Optional[str]) -> None:
    """One kernel launch of ``name``; None counts a callable ring."""
    global callable_rings
    with _count_lock:
        if name is None:
            callable_rings += 1
        else:
            launches[name] += 1


# ---------------------------------------------------------------------------
# Layout (pallas_kernels.py:83-124, as index arithmetic)
# ---------------------------------------------------------------------------

def _tile_rows(count: int, n: int) -> int:
    """Rows of the (rows, LANE) tile holding ``count`` elements, padded so
    the row count splits into n equal SUBLANE-aligned ring chunks."""
    rows = -(-count // LANE)
    chunk = -(-rows // n)
    chunk = -(-chunk // SUBLANE) * SUBLANE
    return chunk * n


def chunk_elems(count: int, n: int) -> int:
    """Elements of one ring chunk of ``ring_allreduce``: element e of a
    rank's tensor lies in chunk ``e // chunk_elems(count, n)``; the chunks
    past the data are padding."""
    return _tile_rows(count, n) // n * LANE


def block_elems(count: int, n: int) -> int:
    """Elements of one rank's block of ``ring_reduce_scatter`` (the cut of
    ``_to_block_tile``: block c is ``[c*per, (c+1)*per)``)."""
    if count % n:
        raise ValueError(f"size {count} not divisible by {n} ranks")
    return count // n


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

_STRING_OPS = {"sum": "SUM", "prod": "PROD", "max": "MAX", "min": "MIN"}


def _combine_fn(op: Any) -> tuple[Optional[str], Callable]:
    """``(kernel op name, combine)`` for an op given as the TPU kernels take
    it (pallas_kernels.py:200-214): a predefined Op, a builtin function,
    any binary callable, or one of the string names. The name is None when
    the op is a callable that no kernel implements."""
    if isinstance(op, str):
        if op not in _STRING_OPS:
            raise ValueError(f"unsupported ring op {op!r}")
        name = _STRING_OPS[op]
        return name, PLAIN_STEP[name]
    op = as_op(op)
    if _PREDEFINED.get(op.name) is op and op.name in PLAIN_STEP:
        return op.name, PLAIN_STEP[op.name]
    return None, op


def stacked_ranks(xs: Any, what: str) -> int:
    """The rank count n of a stacked per-rank tensor (n, ...), n >= 1."""
    if not isinstance(xs, torch.Tensor):
        raise TypeError(f"{what} takes a tensor, got {type(xs).__name__}")
    if xs.dim() < 1 or xs.shape[0] < 1:
        raise ValueError(f"{what} takes the stacked per-rank tensor (n, ...) "
                         f"with n >= 1 ranks, got shape {tuple(xs.shape)}")
    return xs.shape[0]


def _kernel_input(xs: torch.Tensor, what: str, kop: Optional[str] = None) -> None:
    """Refuse what the kernel does not take, before any launch. The
    allgather (``kop`` None) copies bytes and takes every dtype."""
    if xs.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {xs.device}")
    if kop is not None and not supports(kop, xs.dtype):
        raise ValueError(f"{what} kernel does not fold {xs.dtype} under {kop}")
    if not xs.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous stacked tensor")


# ---------------------------------------------------------------------------
# ring_allreduce
# ---------------------------------------------------------------------------

def ring_allreduce_plain(xs: torch.Tensor, combine: Callable) -> torch.Tensor:
    """The TPU kernel's schedule on the stacked tensor: buf[r, j] is rank
    r's ring chunk j. Reduce-scatter hop s: rank r folds in the partial of
    chunk (r-s-1) % n that rank r-1 sends, own value first. Copy hop s:
    rank r takes chunk (r-s) % n from rank r-1. Within a hop no rank
    writes a slot another rank reads, so the hop runs in place."""
    n = xs.shape[0]
    count = xs[0].numel()
    chunk = chunk_elems(count, n)
    buf = xs.new_zeros((n, n * chunk))
    buf[:, :count] = xs.reshape(n, count)
    buf = buf.view(n, n, chunk)
    for s in range(n - 1):
        for r in range(n):
            j = (r - s - 1) % n
            buf[r, j] = combine(buf[r, j], buf[(r - 1) % n, j])
    for s in range(n - 1):
        for r in range(n):
            j = (r - s) % n
            buf[r, j] = buf[(r - 1) % n, j]
    return buf.view(n, n * chunk)[:, :count].reshape(xs.shape)


def ring_allreduce(xs: torch.Tensor, op: Any = "sum") -> torch.Tensor:
    """Allreduce of the stacked per-rank tensor ``xs`` (n, ...): every row
    of the result is the ring-order fold. One rank returns ``xs``."""
    n = stacked_ranks(xs, "ring_allreduce")
    kop, combine = _combine_fn(op)
    if n == 1:
        return xs
    if kop is None:
        _count(None)
        return ring_allreduce_plain(xs, combine)
    if xs.device.type == "cpu":
        return ring_allreduce_plain(xs, combine)
    _kernel_input(xs, "ring_allreduce", kop)
    out = torch.empty_like(xs, memory_format=torch.contiguous_format)
    count = xs[0].numel()
    _build.call(LIBRARY.fn("tmt_ring_allreduce"), xs.device, "ring_allreduce",
                xs.data_ptr(), out.data_ptr(), n, count, chunk_elems(count, n),
                DTYPE_CODE[xs.dtype], OP_CODE[kop])
    _count("ring_allreduce")
    return out


# ---------------------------------------------------------------------------
# ring_reduce_scatter
# ---------------------------------------------------------------------------

def ring_reduce_scatter_plain(xs: torch.Tensor, combine: Callable) -> torch.Tensor:
    """The TPU kernel's schedule: acc[r, j] is rank r's partial of block j.
    Hop s: rank r folds in the partial of block (r-s-2) % n that rank r-1
    sends, own value first; after n-1 hops rank r holds block r."""
    n = xs.shape[0]
    per = block_elems(xs[0].numel(), n)
    acc = xs.reshape(n, n, per).clone()
    for s in range(n - 1):
        for r in range(n):
            j = (r - s - 2) % n
            acc[r, j] = combine(acc[r, j], acc[(r - 1) % n, j])
    return acc.diagonal(dim1=0, dim2=1).movedim(-1, 0).contiguous()


def ring_reduce_scatter(xs: torch.Tensor, op: Any = "sum") -> torch.Tensor:
    """Reduce-scatter of the stacked per-rank tensor ``xs`` (n, ...), each
    rank's size divisible by n: row c of the (n, per) result is block c of
    the ring-order fold. One rank returns ``xs`` flattened per rank."""
    n = stacked_ranks(xs, "ring_reduce_scatter")
    kop, combine = _combine_fn(op)
    if n == 1:
        return xs.reshape(1, -1)
    per = block_elems(xs[0].numel(), n)
    if kop is None:
        _count(None)
        return ring_reduce_scatter_plain(xs, combine)
    if xs.device.type == "cpu":
        return ring_reduce_scatter_plain(xs, combine)
    return _reduce_scatter_kernel(xs, kop, per)


def _reduce_scatter_kernel(xs: torch.Tensor, kop: str, per: int, *,
                           via: Optional[str] = None) -> torch.Tensor:
    """The kernel on the stacked CUDA tensor, or a refusal. The staged route
    (bulk asynchronous copies through shared memory) takes 16-byte-aligned
    bases, blocks of whole 16-byte words and an n it stages
    (:func:`staged_tile`); the direct route takes any. ``via`` names a route
    in place of that choice (for measurement: the kernel must take it)."""
    n = xs.shape[0]
    _kernel_input(xs, "ring_reduce_scatter", kop)
    out = xs.new_empty((n, per))
    way = via or ("staged" if (xs.data_ptr() | out.data_ptr()
                               | per * xs.element_size()) % 16 == 0
                  and staged_tile(n, xs.dtype) else "direct")
    _build.call(LIBRARY.fn("tmt_ring_reduce_scatter"), xs.device,
                "ring_reduce_scatter", xs.data_ptr(), out.data_ptr(), n, per,
                DTYPE_CODE[xs.dtype], OP_CODE[kop], ROUTES.index(way))
    with _count_lock:
        launches["ring_reduce_scatter"] += 1
        route_launches[way] += 1
    return out


def staged_tile(n: int, dtype: torch.dtype) -> int:
    """Elements of one rank's slice of a tile on the staged (bulk-copy)
    route of the reduce-scatter kernel for n ranks, 0 where n takes the
    direct route; read from the kernel library (built on first use)."""
    return _staged_tile(n, dtype.itemsize)


@functools.lru_cache(maxsize=None)
def _staged_tile(n: int, itemsize: int) -> int:
    return int(LIBRARY.fn("tmt_ring_reduce_scatter_tile")(n, itemsize))


# ---------------------------------------------------------------------------
# ring_allgather
# ---------------------------------------------------------------------------

def ring_allgather_plain(xs: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's schedule: every rank places its own row, then hop s
    passes each rank's held row to the next rank, which places it at
    (r-s-1) % n. torch's unsigned 16-64-bit types move as their signed
    views (it has no index_put for them)."""
    signed = _signed(xs)
    if signed is not xs:
        return ring_allgather_plain(signed).view(xs.dtype)
    n = xs.shape[0]
    out = xs.new_empty((n,) + tuple(xs.shape))
    ranks = torch.arange(n, device=xs.device)
    out[ranks, ranks] = xs
    held = xs
    for s in range(n - 1):
        held = held.roll(1, 0)
        out[ranks, (ranks - s - 1) % n] = held
    return out


def ring_allgather(xs: torch.Tensor) -> torch.Tensor:
    """Allgather of the stacked per-rank tensor ``xs`` (n, ...): the
    (n, n, ...) result holds every rank's row in rank order on every rank."""
    n = stacked_ranks(xs, "ring_allgather")
    if xs.device.type == "cpu":
        return ring_allgather_plain(xs)
    _kernel_input(xs, "ring_allgather")
    out = xs.new_empty((n,) + tuple(xs.shape))
    _build.call(LIBRARY.fn("tmt_ring_allgather"), xs.device, "ring_allgather",
                xs.data_ptr(), out.data_ptr(), n, xs.numel() * xs.element_size())
    _count("ring_allgather")
    return out


# ---------------------------------------------------------------------------
# Library
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tmt_ring_allreduce.argtypes = [p, p, i, i64, i64, i, i, p]
    lib.tmt_ring_reduce_scatter.argtypes = [p, p, i, i64, i, i, i, p]
    lib.tmt_ring_allgather.argtypes = [p, p, i, i64, p]
    for fn in (lib.tmt_ring_allreduce, lib.tmt_ring_reduce_scatter,
               lib.tmt_ring_allgather):
        fn.restype = ctypes.c_int
    lib.tmt_ring_reduce_scatter_tile.argtypes = [i, i]
    lib.tmt_ring_reduce_scatter_tile.restype = i64


LIBRARY = _build.Library("ring", SOURCE, _bind)
