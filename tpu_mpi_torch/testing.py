"""Test substrate: run SPMD programs on simulated ranks in one process.

Mirrors the reference's test runner (MPI.jl test/runtests.jl:28-45),
which launches every test file under ``mpiexec -n N``; here each test body runs
under :func:`tpu_mpi_torch.spmd_run` on N rank-threads sharing one device.

The array factories are the port's counterpart of the JAX package's ``AT``
test fixture (ArrayType = Array vs CuArray in the reference): numpy arrays,
and torch tensors in :class:`DeviceBuffer` cells on an explicit device — the
CPU in the CPU test run, the card on the chip.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import numpy as np

from ._runtime import spmd_run
from . import environment
from .buffers import DeviceBuffer, to_numpy


DEFAULT_NPROCS = 4   # clamp(CPU_THREADS, 2, 4) in test/runtests.jl:20-21


def mpi_main(fn: Callable[[], Any]) -> Callable[[], Any]:
    """Wrap a test body in Init/Finalize like every reference test file."""
    @functools.wraps(fn)
    def body(*args: Any) -> Any:
        environment.Init()
        try:
            return fn(*args)
        finally:
            if not environment.Finalized():
                environment.Finalize()
    return body


def run_spmd(fn: Callable[[], Any], nprocs: int = DEFAULT_NPROCS, *,
             init: bool = True, args: tuple = (),
             timeout: Optional[float] = 120.0) -> list:
    """Run fn as an SPMD program on nprocs ranks; Init/Finalize automatically."""
    body = mpi_main(fn) if init else fn
    return spmd_run(body, nprocs, args=args, timeout=timeout)


def aeq(a: Any, b: Any) -> bool:
    """Array equality across the array-type registry (numpy / tensor /
    DeviceBuffer), bitwise for bfloat16 (compared as raw bits)."""
    return bool(np.array_equal(_host(a), _host(b)))


def _host(a: Any) -> np.ndarray:
    if isinstance(a, DeviceBuffer):
        a = a.value
    return to_numpy(a)


class NumpyFactory:
    """ArrayType=Array analog."""
    name = "numpy"

    @staticmethod
    def array(data, dtype=None):
        return np.array(data, dtype=dtype)

    @staticmethod
    def empty(shape, dtype=np.float64):
        return np.empty(shape, dtype=dtype)

    @staticmethod
    def zeros(shape, dtype=np.float64):
        return np.zeros(shape, dtype=dtype)

    @staticmethod
    def full(shape, val, dtype=None):
        return np.full(shape, val, dtype=dtype)


class TensorFactory:
    """ArrayType=CuArray analog: tensors in mutable cells on ``device``."""

    def __init__(self, device: Any):
        self.device = device
        self.name = f"tensor-{device}"

    def array(self, data, dtype=None):
        return DeviceBuffer(np.array(data, dtype=dtype), device=self.device)

    def empty(self, shape, dtype=np.float64):
        return DeviceBuffer(np.zeros(shape, dtype=dtype), device=self.device)

    def zeros(self, shape, dtype=np.float64):
        return DeviceBuffer(np.zeros(shape, dtype=dtype), device=self.device)

    def full(self, shape, val, dtype=None):
        return DeviceBuffer(np.full(shape, val, dtype=dtype), device=self.device)
