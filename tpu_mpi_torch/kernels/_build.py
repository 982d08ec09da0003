"""Build and load the port's CUDA sources.

Each source in ``tpu_mpi_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``tpu_mpi_torch/_build/``. The file name carries a hash of the source,
the headers beside it and the flags, so an edit builds anew; a file lock
makes concurrent processes build it once. The library is loaded with
``ctypes`` and its functions typed by the kernel module that owns it.

Every wrapper launches through :func:`call`, the one lean launch path: it
appends the device's current stream as a raw handle and makes the device
current only when it is not already.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# C interfaces return TMT_EBADARG (fold_ops.cuh) for arguments they refuse.
EBADARG = 100000


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def check(rc: int, what: str) -> None:
    """Raise for a C interface's nonzero return code."""
    if rc != 0:
        why = "bad arguments" if rc == EBADARG else f"cudaError {rc}"
        raise RuntimeError(f"{what} kernel launch failed: {why}")


# The current stream's raw handle and the current device without building a
# torch.cuda.Stream or re-checking CUDA's initialisation (PyTorch's own
# generated code reads them this way); the public calls where a build lacks
# them.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or \
    (lambda index: torch.cuda.current_stream(index).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device


def call(fn: Callable[..., int], device: torch.device, what: str, *args) -> None:
    """Launch ``fn(*args, stream)`` on ``device``'s current stream with the
    device current, and raise for a nonzero return code."""
    index = device.index
    if index == _current_device():
        rc = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
    check(rc, what)


class Library:
    """One CUDA source, built and loaded at first use (thread-safe).
    ``bind(lib)`` sets the ``argtypes``/``restype`` of its functions."""

    def __init__(self, name: str, source: Path,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self._bind = bind
        self._lib = None
        self._fns: dict = {}
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the build of the current sources and flags lives."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless this build exists."""
        so = self.path()
        if so.exists():
            return so
        so.parent.mkdir(parents=True, exist_ok=True)
        with open(so.with_suffix(".lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if so.exists():
                    return so
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{self.name}: nvcc failed\n"
                                       + " ".join(cmd) + "\n" + proc.stderr)
                os.replace(tmp, so)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        return so

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def fn(self, name: str) -> Callable[..., int]:
        """The bound C function ``name``, resolved once."""
        found = self._fns.get(name)
        if found is None:
            found = self._fns[name] = getattr(self.load(), name)
        return found


def build_all(libs: Sequence[Library]) -> list[Path]:
    """Build every library at once, one ``nvcc`` each; returns their paths."""
    with ThreadPoolExecutor(max(1, len(libs))) as pool:
        return list(pool.map(Library.build, libs))
