"""Data-parallel trainer: bucketed gradient Allreduce on the persistent
lane, overlapped with the remaining backward pass — the port of
``tpu_mpi/train/ddp.py``.

The caller owns the forward/backward and feeds the trainer its gradients
one tensor at a time, **in reverse-layer order**. The trainer packs them
into size-bounded float64 buckets (:mod:`tpu_mpi_torch.train.bucketer`),
and the moment a bucket's last gradient lands it ``Start``s that bucket's
persistent Allreduce handle; the ``Wait``s happen at the optimizer fold,
in Start order. On a CUDA tensor each round is one launch of the fused
fold kernel on the persistent lane's slots.

``overlap=False`` is the measurement control: the same bucket layout and
traffic, each bucket a plain blocking ``Allreduce`` at flush time — the
same rank-ordered fold, bitwise-identical results.

The optimizer is SGD with momentum on float64 masters on ``device``
(default ``cuda``), applied with the same elementwise operations, in the
same order, as the JAX package's numpy fold, so both give the same bits.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .. import config as _config
from .. import perfvars as _pv
from ..buffers import as_tensor, resolve_device
from ..collective import Allreduce, Allreduce_init, Bcast
from ..operators import SUM
from ..overlap import hint_buckets
from ..pointtopoint import Start, Wait
from .bucketer import GradBucketer

__all__ = ["DDPTrainer", "arm_bucket"]

CHECKPOINT = ("trainer checkpoints wait for the port's checkpoint.py and "
              "io.py (ROADMAP Queue A #8)")


def arm_bucket(send: Any, recv: Any, comm) -> object:
    """Arm ONE persistent Allreduce handle for a gradient bucket (the name
    is the one the analyzer's bucket-pairing lint keys on). Start/Wait the
    returned handle exactly alternately."""
    return Allreduce_init(send, recv, SUM, comm)


def masters(params: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """float64 master COPIES of ``params`` on ``device`` (never aliasing
    the caller's tensors or arrays)."""
    return {name: as_tensor(p, torch.float64, device).clone()
            for name, p in params.items()}


class DDPTrainer:
    """Bucketed-overlap data-parallel SGD(momentum) over one comm.

    ``params`` maps names to tensors or arrays; they are copied into
    float64 masters on ``device`` and broadcast from rank 0. ``grad_order``
    fixes the gradient arrival order (default: reversed dict order); the
    bucket layout, and so the fold order and the bits, depend only on it.
    """

    def __init__(self, params: Dict[str, Any], comm, *, lr: float = 0.1,
                 momentum: float = 0.9, bucket_bytes: Optional[int] = None,
                 overlap: bool = True,
                 grad_order: Optional[Sequence[str]] = None,
                 device: Any = None) -> None:
        self.comm = comm
        self.device = resolve_device(device)
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.overlap = bool(overlap)
        if bucket_bytes is None:
            bucket_bytes = _config.load().train_bucket_bytes
        self.order: List[str] = list(grad_order) if grad_order is not None \
            else list(reversed(list(params)))
        if set(self.order) != set(params):
            raise ValueError("grad_order must cover exactly the params")

        self.params: Dict[str, torch.Tensor] = masters(params, self.device)
        for name in self.order:
            Bcast(self.params[name], 0, comm)
        self._flat = {name: p.view(-1) for name, p in self.params.items()}
        self._mom = {name: torch.zeros_like(f) for name, f in self._flat.items()}

        self.bucketer = GradBucketer(
            [(name, self._flat[name].numel()) for name in self.order],
            bucket_bytes, device=self.device)
        hint_buckets(comm, len(self.bucketer))
        self._handles = None
        if self.overlap:
            self._handles = [arm_bucket(b.send, b.recv, comm)
                             for b in self.bucketer.buckets]
        self.step_count = 0
        self._wait_ns = 0
        self._window_ns = 0
        _pv.set_train_gauges(nbuckets=len(self.bucketer),
                             bucket_bytes=int(bucket_bytes),
                             world=comm.size())

    # -- per-step fold ------------------------------------------------------

    def step(self, grads: Iterable[Tuple[str, Any]]) -> None:
        """One optimizer step from an iterable of ``(name, grad)`` in the
        configured arrival order. Mutates params in place."""
        t_step = time.perf_counter_ns()
        started: List[Tuple[int, int]] = []   # (bucket index, t0)
        wait_ns = 0
        window_ns = 0
        for name, grad in grads:
            b = self.bucketer.add(name, grad)
            if b is None:
                continue
            _pv.note_train(bucket_flushes=1)
            if self.overlap:
                Start(self._handles[b.index])
                _pv.note_train(starts=1)
                started.append((b.index, time.perf_counter_ns()))
            else:
                t0 = time.perf_counter_ns()
                Allreduce(b.send, b.recv, SUM, self.comm)
                t1 = time.perf_counter_ns()
                wait_ns += t1 - t0
                window_ns += t1 - t0
        if self.overlap:
            for idx, t0 in started:
                t1 = time.perf_counter_ns()
                Wait(self._handles[idx])
                t2 = time.perf_counter_ns()
                _pv.note_train(waits=1)
                wait_ns += t2 - t1
                window_ns += t2 - t0
        self._fold()
        self.bucketer.reset()
        self.step_count += 1
        self._wait_ns += wait_ns
        self._window_ns += window_ns
        _pv.note_train(wait_ns=wait_ns, comm_window_ns=window_ns)
        _pv.note_train_step(time.perf_counter_ns() - t_step)

    def _fold(self) -> None:
        inv = 1.0 / self.comm.size()
        mu, lr = self.momentum, self.lr
        for name in self.order:
            g = self.bucketer.out_view(name) * inv   # mean gradient (own tensor)
            m = self._mom[name]
            m.mul_(mu).add_(g)
            self._flat[name].sub_(torch.mul(m, lr, out=g))

    def overlap_fraction(self) -> float:
        """1 - (blocked Wait time / Start-to-Wait-return comm window), over
        the trainer's lifetime; 0 for the blocking control."""
        if self._window_ns <= 0:
            return 0.0
        return 1.0 - (self._wait_ns / self._window_ns)

    def opt_state_bytes(self) -> int:
        """Optimizer-state footprint (the momentum flats): full-size per
        rank — the quantity FSDP shards 1/nranks."""
        return sum(m.numel() * m.element_size() for m in self._mom.values())

    def save(self, path: str) -> None:
        raise NotImplementedError(CHECKPOINT)

    def load(self, path: str) -> int:
        raise NotImplementedError(CHECKPOINT)
