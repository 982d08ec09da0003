"""ZeRO-style sharded-state data parallelism (`TPU_MPI_TRAIN_SHARD_STATE`)
— the port of ``tpu_mpi/train/fsdp.py``.

Where :class:`~tpu_mpi_torch.train.ddp.DDPTrainer` replicates the
optimizer state on every rank, this trainer shards it 1/nranks:

- master params live in ONE padded float64 flat on ``device``; rank r
  owns slice r;
- the per-step fold is ``Reduce_scatter_block`` (each rank receives only
  the reduced gradient for its own slice; the fused fold kernel on a CUDA
  tensor), an in-place SGD(momentum) update of that slice, then an
  IN_PLACE ``Allgather`` that republishes the updated slices into every
  rank's full flat;
- the momentum buffer is slice-sized, so optimizer-state bytes scale
  ~1/nranks against DDP (:meth:`opt_state_bytes`).

The gradient mean divides by nranks BEFORE the momentum fold, with the
same elementwise operations as the DDP fold, so a same-gradient FSDP run
gives DDP's bits.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch

from .. import checkpoint as _ckpt
from .. import perfvars as _pv
from ..buffers import IN_PLACE, resolve_device
from ..collective import Allgather, Bcast, Reduce_scatter_block
from ..operators import SUM
from .bucketer import _flat_grad
from .ddp import fill_range, masters

__all__ = ["FSDPTrainer"]


class FSDPTrainer:
    """Sharded-state SGD(momentum) over one comm. Same thin contract as
    DDP: the caller feeds ``(name, grad)`` pairs per step, in any order."""

    def __init__(self, params: Dict[str, Any], comm, *, lr: float = 0.1,
                 momentum: float = 0.9, device: Any = None) -> None:
        self.comm = comm
        self.device = resolve_device(device)
        self.lr = float(lr)
        self.momentum = float(momentum)
        size = comm.size()
        self.order: List[str] = list(params)
        start = masters(params, self.device)
        counts = {n: start[n].numel() or 1 for n in self.order}
        n = sum(counts.values())
        self._n = n
        self._padded = ((n + size - 1) // size) * size
        self._shard = self._padded // size
        lo = comm.rank() * self._shard

        # ONE padded flat for master params; per-param shaped views
        f64 = dict(dtype=torch.float64, device=self.device)
        self._flat = torch.zeros(self._padded, **f64)
        self.params: Dict[str, torch.Tensor] = {}
        self._gradflat = torch.zeros(self._padded, **f64)
        self._gviews: Dict[str, torch.Tensor] = {}
        off = 0
        for name in self.order:
            c = counts[name]
            view = self._flat[off:off + c]
            view.copy_(start[name].reshape(-1))
            self.params[name] = view.view(start[name].shape)
            self._gviews[name] = self._gradflat[off:off + c]
            off += c
        Bcast(self._flat, 0, comm)

        # shard-sized state: the reduced grad landing zone and the
        # momentum buffer (THE optimizer state that shards 1/nranks)
        self._gshard = torch.zeros(self._shard, **f64)
        self._mshard = torch.zeros(self._shard, **f64)
        self._my_slice = self._flat[lo:lo + self._shard]
        self.step_count = 0

    def step(self, grads: Iterable[Tuple[str, Any]]) -> None:
        """One sharded optimizer step; mutates params in place."""
        t_step = time.perf_counter_ns()
        for name, grad in grads:
            self._gviews[name].copy_(_flat_grad(grad))
        t0 = time.perf_counter_ns()
        Reduce_scatter_block(self._gradflat, self._gshard, SUM, self.comm)
        self._gshard.mul_(1.0 / self.comm.size())
        self._mshard.mul_(self.momentum).add_(self._gshard)
        torch.mul(self._mshard, self.lr, out=self._gshard)
        self._my_slice.sub_(self._gshard)
        Allgather(IN_PLACE, self._flat, self._shard, self.comm)
        t1 = time.perf_counter_ns()
        self.step_count += 1
        _pv.note_train(bucket_flushes=1, wait_ns=t1 - t0,
                       comm_window_ns=t1 - t0)
        _pv.note_train_step(time.perf_counter_ns() - t_step)

    def opt_state_bytes(self) -> int:
        """Optimizer-state footprint: the shard-sized momentum buffer —
        ~1/nranks of the DDP equivalent."""
        return self._mshard.numel() * self._mshard.element_size()

    # -- checkpoint / reshard ----------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint this rank's OWN slice of params + momentum (the
        natural ZeRO sharding: no gather, no replication)."""
        _ckpt.save_sharded(
            path, {"step": np.array([self.step_count], dtype=np.int64),
                   "params": self._my_slice,
                   "mom": self._mshard,
                   "n": np.array([self._n], dtype=np.int64)}, self.comm)

    def load(self, path: str) -> int:
        """Restore from :meth:`save`, resharding across a different world
        size: each writer shard's params land in the full flat, and the
        part of its momentum inside this rank's slice in the momentum
        shard, in place, one shard at a time. Writers may have padded to
        another multiple: only the first n elements are state, the rest
        is zero."""
        lo = self.comm.rank() * self._shard
        self._flat.zero_()
        self._mshard.zero_()
        poff = 0
        for s in range(_ckpt.shard_count(path, self.comm)):
            shard = _ckpt.load_sharded(path, self.comm, shard=s)
            n = int(shard["n"][0])
            if n != self._n:
                raise ValueError(
                    f"checkpoint holds {n} params, trainer has {self._n}")
            params, mom = shard["params"], shard["mom"]
            keep = max(0, min(params.size, n - poff))
            fill_range([self._flat], poff, params[:keep])
            a, b = max(lo, poff), min(lo + self._shard, poff + keep)
            if a < b:
                fill_range([self._mshard], a - lo, mom[a - poff:b - poff])
            poff += params.size
            self.step_count = int(shard["step"][0])
        _pv.note_train(reshards=1)
        return self.step_count
