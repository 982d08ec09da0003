"""Fused rank-ordered fold: the port of the Pallas kernel
``tpu_mpi/xla/pallas_kernels.py::fused_multi_reduce``.

``fused_multi_reduce(xs, op)`` folds ``n`` same-shape tensors into one
output as the LEFT fold in rank order, ``op(...op(op(x0, x1), x2)..., xn-1)``,
reading every stream once and writing the output once. It is the host-path
``Allreduce`` fold of :mod:`tpu_mpi_torch.collective`.

On a CUDA tensor the wrapper launches the hand-written kernel in
``tpu_mpi_torch/csrc/fused_reduce.cu`` (a grid-stride elementwise loop over
up to ``N_MAX`` operand pointers per launch, chained launches beyond that),
or raises: a build or launch failure is never hidden. On a CPU tensor it
runs :func:`fused_multi_reduce_plain`, the chained PyTorch fold beside it,
which is also the kernel's oracle on the card. The two agree bitwise: each
fold step rounds to the storage type exactly as PyTorch's own elementwise
op does (see the kernel source for the rules).

The kernel is bound by bytes: ``(n + 1) * count * itemsize`` of device
memory traffic, against ``n - 1`` cheap operations per element.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface under ``tpu_mpi_torch/_build/``, at first use,
keyed by a hash of the source and flags, under a file lock so concurrent
processes build it once. Loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import operator
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

REPLACES = "tpu_mpi/xla/pallas_kernels.py:655"     # fused_multi_reduce

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_reduce.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

N_MAX = 16                  # operand pointers per launch (csrc N_MAX)
_EBADARG = 100000           # csrc TMT_EBADARG

# dtype -> kernel code (csrc enum Dtype)
_DTYPE_CODE = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3,
    torch.int8: 4, torch.int16: 5, torch.int32: 6, torch.int64: 7,
    torch.uint8: 8, torch.bool: 9,
}
_FLOAT_OPS = ("SUM", "PROD", "MAX", "MIN")
_INT_OPS = _FLOAT_OPS + ("BAND", "BOR", "BXOR")
# op name -> kernel code (csrc enum Op)
_OP_CODE = {name: i for i, name in enumerate(_INT_OPS)}

# The plain fold steps: exactly the tensor operations the reduction
# operators of tpu_mpi_torch.operators apply.
_PLAIN_STEP = {
    "SUM": operator.add, "PROD": operator.mul,
    "MAX": torch.maximum, "MIN": torch.minimum,
    "BAND": operator.and_, "BOR": operator.or_, "BXOR": operator.xor,
}


def supports(op: str, dtype: torch.dtype) -> bool:
    """Whether the kernel folds ``dtype`` under the predefined op ``op``."""
    if dtype not in _DTYPE_CODE:
        return False
    ops = _FLOAT_OPS if dtype.is_floating_point else _INT_OPS
    return op in ops


# Launches of the kernel, one per wrapper call that launched it.
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def fused_multi_reduce_plain(xs: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """The plain version: the chained PyTorch left fold."""
    return functools.reduce(_PLAIN_STEP[op], xs)


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
    if op not in _PLAIN_STEP:
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
    lib = load_library()
    ptrs = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = lib.tmt_fused_reduce(ptrs, len(xs), out.data_ptr(), x0.numel(),
                                  _DTYPE_CODE[x0.dtype], _OP_CODE[op], stream)
    if rc != 0:
        what = "bad arguments" if rc == _EBADARG else f"cudaError {rc}"
        raise RuntimeError(f"fused_multi_reduce kernel launch failed: {what}")
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


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("fused_multi_reduce: nvcc not found (set CUDA_HOME)")
    return found


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"fused_reduce-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if so.exists():
                return so
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("fused_multi_reduce: nvcc failed\n"
                                   + " ".join(cmd) + "\n" + proc.stderr)
            os.replace(tmp, so)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return so


def load_library():
    """The loaded kernel library, built at first use (thread-safe)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.tmt_fused_reduce
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib
