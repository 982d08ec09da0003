"""Gradient bucketing for the data-parallel training tier — the port of
``tpu_mpi/train/bucketer.py``.

The backward pass produces gradients in reverse-layer order (the last
layer's grad is ready first). :class:`GradBucketer` packs them, in that
arrival order, into size-bounded flat float64 buckets so each bucket can
ride ONE persistent Allreduce the moment its last gradient lands. The
bucket byte bound (`TPU_MPI_TRAIN_BUCKET_BYTES`, default 1 MiB) trades
per-op overhead against overlap; a parameter larger than the bound gets a
bucket of its own.

Buckets are laid out ONCE from the parameter spec and reused every step.
``send`` and ``recv`` are :class:`~tpu_mpi_torch.buffers.DeviceBuffer`
cells on the trainer's device, so the persistent Allreduce takes the
device lane (the fused fold kernel on a CUDA tensor). Packing copies into
views of ``send``'s tensor, which no one else holds. ``recv`` is rebound
by every round to the lane's result — on the persistent lane one of two
preallocated slots shared by every rank, valid until round k+2 — so the
reduced gradient is read through :meth:`Bucket.out_view` at fold time,
never through a view taken earlier, and never written.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..buffers import DeviceBuffer, resolve_device

__all__ = ["Bucket", "GradBucketer"]


def _flat_grad(grad: Any) -> torch.Tensor:
    if isinstance(grad, torch.Tensor):
        return grad.detach().reshape(-1)
    return torch.from_numpy(np.ascontiguousarray(grad)).reshape(-1)


class Bucket:
    """One flat gradient bucket: a contiguous send/recv pair of cells plus
    each parameter's span in them."""

    __slots__ = ("index", "names", "send", "recv", "_spans", "_arrived")

    def __init__(self, index: int, spec: Sequence[Tuple[str, int]],
                 device: torch.device) -> None:
        self.index = index
        self.names = [name for name, _ in spec]
        total = sum(n for _, n in spec)
        self.send = DeviceBuffer(torch.zeros(total, dtype=torch.float64,
                                             device=device), device=device)
        self.recv = DeviceBuffer(torch.zeros(total, dtype=torch.float64,
                                             device=device), device=device)
        self._spans: Dict[str, Tuple[int, int]] = {}
        off = 0
        for name, n in spec:
            self._spans[name] = (off, n)
            off += n
        self._arrived: set = set()

    @property
    def nbytes(self) -> int:
        return int(self.send.nbytes)

    def add(self, name: str, grad: Any) -> bool:
        """Copy ``grad`` (a tensor of any dtype and device, or an array)
        into this bucket's send flat, in float64. Returns True when the
        bucket is full (every owned gradient has arrived)."""
        off, n = self._spans[name]
        self.send.value.narrow(0, off, n).copy_(_flat_grad(grad))
        self._arrived.add(name)
        return len(self._arrived) == len(self.names)

    def out_view(self, name: str) -> torch.Tensor:
        """The reduced gradient for ``name``: a view into the tensor
        ``recv`` holds now (read-only: ranks may share it)."""
        off, n = self._spans[name]
        return self.recv.value.reshape(-1).narrow(0, off, n)

    def reset(self) -> None:
        self._arrived.clear()


class GradBucketer:
    """Size-bounded reverse-layer-order bucket layout over a fixed
    parameter spec ``[(name, element_count), ...]`` (the ARRIVAL order:
    pass the last layer first). Layout happens once; each step calls
    :meth:`add` per gradient and gets the bucket back when its last member
    lands, then :meth:`reset` before the next step. Buckets live on
    ``device`` (default ``cuda``)."""

    def __init__(self, spec: Sequence[Tuple[str, int]],
                 bucket_bytes: int = 1 << 20, device: Any = None) -> None:
        if bucket_bytes < 8:
            raise ValueError(f"bucket_bytes {bucket_bytes} < one element")
        self.device = resolve_device(device)
        self.bucket_bytes = int(bucket_bytes)
        self.buckets: List[Bucket] = []
        self._owner: Dict[str, Bucket] = {}
        cur: List[Tuple[str, int]] = []
        cur_bytes = 0
        for name, count in spec:
            n = int(count)
            nbytes = n * 8
            if cur and cur_bytes + nbytes > self.bucket_bytes:
                self._seal(cur)
                cur, cur_bytes = [], 0
            cur.append((name, n))
            cur_bytes += nbytes
        if cur:
            self._seal(cur)

    def _seal(self, spec: List[Tuple[str, int]]) -> None:
        b = Bucket(len(self.buckets), spec, self.device)
        self.buckets.append(b)
        for name in b.names:
            self._owner[name] = b

    def __len__(self) -> int:
        return len(self.buckets)

    def add(self, name: str, grad: Any):
        """Route one gradient to its bucket. Returns the :class:`Bucket`
        when this grad completed it, else None."""
        b = self._owner[name]
        return b if b.add(name, grad) else None

    def out_view(self, name: str) -> torch.Tensor:
        return self._owner[name].out_view(name)

    def reset(self) -> None:
        for b in self.buckets:
            b.reset()
