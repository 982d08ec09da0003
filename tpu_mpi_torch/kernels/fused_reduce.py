"""Fused rank-ordered fold: the port of the Pallas kernel
``tpu_mpi/xla/pallas_kernels.py::fused_multi_reduce``.

``fused_multi_reduce(xs, op)`` folds ``n`` same-shape tensors into one
output as the LEFT fold in rank order, ``op(...op(op(x0, x1), x2)..., xn-1)``,
reading every stream once and writing the output once. It is the host-path
``Allreduce`` fold of :mod:`tpu_mpi_torch.collective`.

On a CUDA tensor the wrapper launches the hand-written kernel in
``tpu_mpi_torch/csrc/fused_reduce.cu``, or raises: a build or launch
failure is never hidden. On a CPU tensor it runs
:func:`fused_multi_reduce_plain`, the chained PyTorch fold beside it,
which is also the kernel's oracle on the card. The two agree bitwise: each
fold step rounds to the storage type exactly as PyTorch's own elementwise
op does (see the kernel source for the rules).

The kernel is bound by bytes: ``(n + 1) * count * itemsize`` of device
memory traffic, against ``n - 1`` cheap operations per element. It has two
routes, chosen up front by :func:`route` from the pointers and the size and
counted by route: "staged" (every operand and ``out`` 16-byte
aligned and the fold whole 16-byte words: one CTA a tile, the n slices of
the tile brought into shared memory by bulk asynchronous copies on one
mbarrier, folded 16 bytes at a time) and "direct" (anything else: 16-byte
or scalar loads straight from device memory, the ragged tail in the same
launch). Up to 16 operands fold in one launch; more run as chained launches
on the same route, and still count as one launch.

Build: :mod:`tpu_mpi_torch.kernels._build` (nvcc for ``sm_90a`` into
``tpu_mpi_torch/_build/`` at first use, loaded with ``ctypes``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _build
from .fold_ops import DTYPE_CODE, OP_CODE, PLAIN_STEP, supports

REPLACES = "tpu_mpi/xla/pallas_kernels.py:655"     # fused_multi_reduce

SOURCE = _build.CSRC / "fused_reduce.cu"

N_MAX = 16          # operands one launch folds (N_MAX in the kernel source)

ROUTES = _build.COUNTED["fold_route_launches"]     # ("staged", "direct")

__getattr__ = _build.views(__name__, {"launches": "fold_launches",
                                      "route_launches": "fold_route_launches"})


def fused_multi_reduce_plain(xs: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """The plain version: the chained PyTorch left fold."""
    return functools.reduce(PLAIN_STEP[op], xs)


def fused_multi_reduce(xs: Sequence[torch.Tensor], op: str, *,
                       out: Optional[torch.Tensor] = None,
                       via: Optional[str] = None) -> torch.Tensor:
    """Fold ``xs`` (same shape and dtype) under the predefined op named
    ``op`` in rank order. ``out``, when given, receives the result and is
    returned (the persistent lane's preallocated slot); it may be any
    operand itself, never a window that overlaps an operand in part (that
    raises on every device). Otherwise
    the output is allocated. One operand and no ``out`` returns it
    unchanged. CPU tensors take the plain fold; CUDA tensors launch the
    kernel on the route :func:`route` gives, or on ``via`` (for tests and
    measurement; the kernel must take it)."""
    xs = list(xs)
    if not xs:
        raise ValueError("fused_multi_reduce needs at least one operand")
    if op not in PLAIN_STEP:
        raise ValueError(f"fused_multi_reduce: no kernel op {op!r}")
    if via is not None and via not in ROUTES:
        raise ValueError(f"fused_multi_reduce: no route {via!r}")
    if len(xs) == 1 and out is None:
        return xs[0]
    x0 = xs[0]
    for x in xs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"fused_multi_reduce takes tensors, got {type(x).__name__}")
        if x.device != x0.device or x.dtype != x0.dtype or x.shape != x0.shape:
            raise ValueError("fused_multi_reduce operands differ in device, "
                             "dtype or shape")
    if out is not None:
        if out.device != x0.device or out.dtype != x0.dtype or out.shape != x0.shape:
            raise ValueError("fused_multi_reduce: out differs from the operands in "
                             "device, dtype or shape")
        _check_no_partial_overlap(xs, out)
    if x0.device.type == "cpu":
        res = fused_multi_reduce_plain(xs, op)
        if out is None:
            return res
        return out.copy_(res)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_multi_reduce: no kernel for device {x0.device}")
    return _launch(xs, op, out, via)


def route(xs: Sequence[torch.Tensor], out: torch.Tensor) -> str:
    """The kernel's route for contiguous operands ``xs`` folded into
    ``out``: "staged" where every operand and ``out`` start on a 16-byte
    boundary and the fold is a whole number of 16-byte words, "direct"
    otherwise. Any number of operands: beyond 16, every chained launch
    takes the same route. Plain arithmetic over pointers and sizes."""
    bits = out.data_ptr() | out.numel() * out.element_size()
    for x in xs:
        bits |= x.data_ptr()
    return "staged" if bits % 16 == 0 else "direct"


def _launch(xs: list, op: str, out: Optional[torch.Tensor],
            via: Optional[str]) -> torch.Tensor:
    x0 = xs[0]
    if not supports(op, x0.dtype):
        raise ValueError(f"fused_multi_reduce kernel does not fold {x0.dtype} "
                         f"under {op}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("fused_multi_reduce kernel takes contiguous operands")
    if out is None:
        out = torch.empty_like(x0, memory_format=torch.contiguous_format)
    elif not out.is_contiguous():
        raise ValueError("fused_multi_reduce kernel takes a contiguous out")
    elif any(x.data_ptr() == out.data_ptr() for x in xs[N_MAX:]):
        # a chained launch would read the accumulator in place of that operand
        return out.copy_(_launch(xs, op, None, via))
    way = route(xs, out)
    if via == "staged" and way != "staged":
        raise ValueError("fused_multi_reduce: the staged route takes 16-byte-"
                         "aligned operands and out and whole 16-byte words")
    way = via or way
    ptrs = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    _build.call(LIBRARY.fn("tmt_fused_reduce"), x0.device, "fused_multi_reduce",
                ptrs, len(xs), out.data_ptr(), x0.numel(), DTYPE_CODE[x0.dtype],
                OP_CODE[op], ROUTES.index(way))
    _build.counts.add("fold_route_launches", way)
    return out


def staged_tile(n: int, dtype: torch.dtype) -> int:
    """Elements of one operand's slice of a tile on the staged route for a
    launch of n operands (at most 16); read from the kernel library (built
    on first use)."""
    return int(LIBRARY.fn("tmt_fused_reduce_tile")(n, dtype.itemsize))


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' storage byte ranges intersect."""
    alo, blo = a.data_ptr(), b.data_ptr()
    return (alo < blo + b.numel() * b.element_size()
            and blo < alo + a.numel() * a.element_size())


def _check_no_partial_overlap(xs: list, out: torch.Tensor) -> None:
    """``out`` may be any operand exactly: a launch reads each element, or
    its CTA's whole tile, before writing it, and an operand past the first
    launch folds into a fresh tensor first (:func:`_launch`). A window that
    overlaps an operand in part raises on every device."""
    for x in xs:
        if overlaps(x, out) and x.data_ptr() != out.data_ptr():
            raise ValueError("fused_multi_reduce: out partially overlaps an operand")


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.tmt_fused_reduce
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tile = lib.tmt_fused_reduce_tile
    tile.argtypes = [ctypes.c_int, ctypes.c_int]
    tile.restype = ctypes.c_int64


LIBRARY = _build.Library("fused_reduce", SOURCE, _bind)
