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
The masters and the momentum are each one flat tensor in arrival order, so
every bucket owns one contiguous range of each; ``params[name]`` is a view
of the master flat. The fold is :func:`tpu_mpi_torch.kernels.ddp_step.update`
over the buckets' ranges (on the card ``ceil(buckets / 32)`` launches).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import checkpoint as _ckpt
from .. import config as _config
from .. import perfvars as _pv
from ..buffers import DeviceBuffer, as_tensor, resolve_device
from ..collective import Allreduce, Allreduce_init, Bcast
from ..kernels import ddp_step
from ..operators import SUM
from ..overlap import hint_buckets
from ..pointtopoint import Start, Wait
from .bucketer import GradBucketer

__all__ = ["DDPTrainer", "arm_bucket"]


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


def _numel(p: Any) -> int:
    if isinstance(p, DeviceBuffer):
        p = p.value
    return p.numel() if isinstance(p, torch.Tensor) else int(np.size(p))


def stage_range(segs: Sequence[torch.Tensor], lo: int, hi: int) -> np.ndarray:
    """Elements [lo, hi) of the concatenation of the flat tensors ``segs``,
    staged to one host array piece by piece (nothing else is copied)."""
    host = torch.empty(hi - lo, dtype=segs[0].dtype)
    off = 0
    for seg in segs:
        a, b = max(lo, off), min(hi, off + seg.numel())
        if a < b:
            host[a - lo:b - lo].copy_(seg[a - off:b - off])
        off += seg.numel()
    return host.numpy()


def fill_range(segs: Sequence[torch.Tensor], lo: int, vals: np.ndarray) -> None:
    """Copy ``vals`` into elements [lo, lo + vals.size) of the concatenation
    of the flat tensors ``segs``, in place (the inverse of
    :func:`stage_range`)."""
    src = torch.from_numpy(vals)
    hi, off = lo + vals.size, 0
    for seg in segs:
        a, b = max(lo, off), min(hi, off + seg.numel())
        if a < b:
            seg[a - off:b - off].copy_(src[a - lo:b - lo])
        off += seg.numel()


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

        total = 0
        spans = {}
        for name in self.order:
            spans[name] = (total, _numel(params[name]))
            total += spans[name][1]
        f64 = dict(dtype=torch.float64, device=self.device)
        self._master = torch.empty(total, **f64)
        self._momentum = torch.zeros(total, **f64)
        self._flat = {name: self._master.narrow(0, *spans[name]) for name in params}
        self._mom = {name: self._momentum.narrow(0, *spans[name]) for name in params}
        self.params: Dict[str, torch.Tensor] = {}
        for name, p in params.items():
            src = as_tensor(p, torch.float64, self.device)
            self.params[name] = self._flat[name].view(src.shape)
            self.params[name].copy_(src)
        for name in self.order:
            Bcast(self.params[name], 0, comm)

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
        configured arrival order. Mutates params in place. A gradient is
        read when the last one of its bucket arrives, so the caller leaves
        it unwritten until then.

        Timed into the ``perfvars`` train counters: ``pack_ns`` (the
        bucketer's recording and packing), ``start_ns``, ``wait_ns`` (with
        the blocking control's ``Allreduce``), ``optimizer_ns`` (the fold)
        and ``step_ns``; with the span ring on, ``ddp.step`` holds one
        ``ddp.pack`` (from a bucket's first gradient to its pack, the
        caller's iterator between them included), ``ddp.start`` and ``ddp.wait`` a
        bucket and one ``ddp.optimizer``; a raise closes ``ddp.step`` and
        leaves the thread's span depth as it found it."""
        clock = time.perf_counter_ns
        t_step = clock()
        s_step = _pv.span_begin(cpu=False)
        try:
            started: List[Tuple[int, int]] = []   # (bucket index, t0)
            pack_ns = start_ns = wait_ns = window_ns = 0
            flushes = 0
            packing = False
            for name, grad in grads:
                if not packing:
                    s_pack, packing = _pv.span_begin(), True
                t0 = clock()
                b = self.bucketer.add(name, grad)
                t1 = clock()
                pack_ns += t1 - t0
                if b is None:
                    continue
                _pv.span_end("ddp.pack", s_pack)
                packing = False
                flushes += 1
                if self.overlap:
                    s = _pv.span_begin()
                    Start(self._handles[b.index])
                    _pv.span_end("ddp.start", s)
                    t2 = clock()
                    start_ns += t2 - t1
                    started.append((b.index, t2))
                else:
                    s = _pv.span_begin(cpu=False)
                    t0 = clock()
                    Allreduce(b.send, b.recv, SUM, self.comm)
                    t2 = clock()
                    _pv.span_end("ddp.wait", s)
                    wait_ns += t2 - t0
                    window_ns += t2 - t0
            if packing:
                _pv.span_end("ddp.pack", s_pack)
            for idx, t0 in started:
                s = _pv.span_begin(cpu=False)
                t1 = clock()
                Wait(self._handles[idx])
                t2 = clock()
                _pv.span_end("ddp.wait", s)
                wait_ns += t2 - t1
                window_ns += t2 - t0
            s = _pv.span_begin()
            t0 = clock()
            self._fold()
            t1 = clock()
            _pv.span_end("ddp.optimizer", s)
            self.bucketer.reset()
            self.step_count += 1
            self._wait_ns += wait_ns
            self._window_ns += window_ns
            _pv.note_train(bucket_flushes=flushes, starts=len(started),
                           waits=len(started), wait_ns=wait_ns,
                           comm_window_ns=window_ns, pack_ns=pack_ns,
                           start_ns=start_ns, optimizer_ns=t1 - t0)
            _pv.note_train_step(clock() - t_step)
        finally:
            _pv.span_end("ddp.step", s_step)

    def _fold(self) -> None:
        ddp_step.update(self._master, self._momentum,
                        [(b.base, b.count, b.recv.value) for b in self.bucketer.buckets],
                        1.0 / self.comm.size(), self.momentum, self.lr)

    def overlap_fraction(self) -> float:
        """1 - (blocked Wait time / Start-to-Wait-return comm window), over
        the trainer's lifetime; 0 for the blocking control."""
        if self._window_ns <= 0:
            return 0.0
        return 1.0 - (self._wait_ns / self._window_ns)

    def opt_state_bytes(self) -> int:
        """Optimizer-state footprint (the momentum flats): full-size per
        rank — the quantity FSDP shards 1/nranks."""
        return self._momentum.numel() * self._momentum.element_size()

    # -- checkpoint / reshard ----------------------------------------------

    def _state(self) -> List[torch.Tensor]:
        """The packed global state: params then momentum, each in arrival
        order."""
        return [self._master, self._momentum]

    def save(self, path: str) -> None:
        """Collectively checkpoint params + momentum + step, sharded
        1/nranks: rank r writes slice r of the packed global state, as
        ``np.array_split`` cuts it — the JAX package's file for the same
        state. Only this rank's slice is staged to host. Any later world
        can :meth:`load` it back."""
        total = sum(t.numel() for t in self._state())
        size, rank = self.comm.size(), self.comm.rank()
        q, r = divmod(total, size)
        lo = rank * q + min(rank, r)
        mine = stage_range(self._state(), lo, lo + q + (rank < r))
        _ckpt.save_sharded(
            path, {"step": np.array([self.step_count], dtype=np.int64),
                   "state": mine}, self.comm)

    def load(self, path: str) -> int:
        """Restore from :meth:`save`, resharding when the writer world
        differs from this one: every rank reads ALL shards, one at a
        time, into its masters in place. Returns the restored step count."""
        segs = self._state()
        total = sum(t.numel() for t in segs)
        off = 0
        for s in range(_ckpt.shard_count(path, self.comm)):
            shard = _ckpt.load_sharded(path, self.comm, shard=s)
            part = shard["state"]
            if off + part.size > total:
                raise ValueError(f"checkpoint state exceeds the trainer's "
                                 f"{total} elements")
            fill_range(segs, off, part)
            off += part.size
            self.step_count = int(shard["step"][0])
        if off != total:
            raise ValueError(
                f"checkpoint state has {off} elements, trainer needs {total}")
        _pv.note_train(reshards=1)
        return self.step_count
