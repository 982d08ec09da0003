"""Fused rank-ordered fold: the port of the Pallas kernel
``tpu_mpi/xla/pallas_kernels.py::fused_multi_reduce``.

``fused_multi_reduce(xs, op)`` folds ``n`` same-shape tensors into one
output as the LEFT fold in rank order, ``op(...op(op(x0, x1), x2)..., xn-1)``,
reading every stream once and writing the output once. It is the host-path
``Allreduce`` fold of :mod:`tpu_mpi_torch.collective`.

On a CUDA tensor the wrapper launches the hand-written kernel in
``tpu_mpi_torch/csrc/fused_reduce.cu`` (a grid-stride elementwise loop over
up to 16 operand pointers per launch, chained launches beyond that),
or raises: a build or launch failure is never hidden. On a CPU tensor it
runs :func:`fused_multi_reduce_plain`, the chained PyTorch fold beside it,
which is also the kernel's oracle on the card. The two agree bitwise: each
fold step rounds to the storage type exactly as PyTorch's own elementwise
op does (see the kernel source for the rules).

The kernel is bound by bytes: ``(n + 1) * count * itemsize`` of device
memory traffic, against ``n - 1`` cheap operations per element.

Build: :mod:`tpu_mpi_torch.kernels._build` (nvcc for ``sm_90a`` into
``tpu_mpi_torch/_build/`` at first use, loaded with ``ctypes``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence

import torch

from . import _build
from .fold_ops import DTYPE_CODE, OP_CODE, PLAIN_STEP, supports

REPLACES = "tpu_mpi/xla/pallas_kernels.py:655"     # fused_multi_reduce

SOURCE = _build.CSRC / "fused_reduce.cu"

# Launches of the kernel, one per wrapper call that launched it.
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def fused_multi_reduce_plain(xs: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """The plain version: the chained PyTorch left fold."""
    return functools.reduce(PLAIN_STEP[op], xs)


def fused_multi_reduce(xs: Sequence[torch.Tensor], op: str, *,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold ``xs`` (same shape and dtype) under the predefined op named
    ``op`` in rank order. ``out``, when given, receives the result and is
    returned (the persistent lane's preallocated slot); otherwise the
    output is allocated. One operand and no ``out`` returns it unchanged.
    CPU tensors take the plain fold; CUDA tensors launch the kernel."""
    xs = list(xs)
    if not xs:
        raise ValueError("fused_multi_reduce needs at least one operand")
    if op not in PLAIN_STEP:
        raise ValueError(f"fused_multi_reduce: no kernel op {op!r}")
    if len(xs) == 1 and out is None:
        return xs[0]
    x0 = xs[0]
    for x in xs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"fused_multi_reduce takes tensors, got {type(x).__name__}")
        if x.device != x0.device or x.dtype != x0.dtype or x.shape != x0.shape:
            raise ValueError("fused_multi_reduce operands differ in device, "
                             "dtype or shape")
    if out is not None and (out.device != x0.device or out.dtype != x0.dtype
                            or out.shape != x0.shape):
        raise ValueError("fused_multi_reduce: out differs from the operands in "
                         "device, dtype or shape")
    if x0.device.type == "cpu":
        res = fused_multi_reduce_plain(xs, op)
        if out is None:
            return res
        return out.copy_(res)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_multi_reduce: no kernel for device {x0.device}")
    return _launch(xs, op, out)


def _launch(xs: list, op: str, out: Optional[torch.Tensor]) -> torch.Tensor:
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
    else:
        _check_no_partial_overlap(xs, out)
    ptrs = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    _build.call(LIBRARY.fn("tmt_fused_reduce"), x0.device, "fused_multi_reduce",
                ptrs, len(xs), out.data_ptr(), x0.numel(), DTYPE_CODE[x0.dtype],
                OP_CODE[op])
    global launches
    with _count_lock:
        launches += 1
    return out


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' storage byte ranges intersect."""
    alo, blo = a.data_ptr(), b.data_ptr()
    return (alo < blo + b.numel() * b.element_size()
            and blo < alo + a.numel() * a.element_size())


def _check_no_partial_overlap(xs: list, out: torch.Tensor) -> None:
    """``out`` may be one of the operands exactly (each element is read
    before the same thread writes it), never a shifted window over one."""
    for x in xs:
        if overlaps(x, out) and x.data_ptr() != out.data_ptr():
            raise ValueError("fused_multi_reduce: out partially overlaps an operand")


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.tmt_fused_reduce
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("fused_reduce", SOURCE, _bind)
