"""Admission control + deficit-round-robin fair queueing for collective slots.

The broker owns one warm device pool; tenants submit collectives that all
contend for it. Three mechanisms keep one tenant from starving the rest
(docs/serving.md "Fair queueing"):

- **bounded queue depth** per tenant: a submit past ``max_depth`` is
  rejected with the retriable :class:`~tpu_mpi_torch.error.ServeBusyError`
  (backpressure surfaces as a status, never as an unbounded buffer);
- **bounded concurrency** per tenant: at most ``max_inflight`` of a
  tenant's collectives occupy pool slots at once, however deep its queue;
- **deficit round-robin** across tenants: each visit of the ring grants a
  tenant ``quantum`` bytes of credit; an op dispatches only when the
  tenant's accumulated deficit covers its byte cost, so many small ops and
  few big ops get proportionate shares of pool bandwidth (the classic DRR
  schedule of Shreedhar & Varghese, applied to collective payload bytes).

Everything is deterministic given a submission order — tests assert pop
order directly instead of racing timers.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from .. import locksmith
from ..error import ServeBusyError, SessionError


class FairQueue:
    """DRR scheduler over per-tenant FIFO queues (one broker dispatcher
    pops; any number of handler threads submit)."""

    def __init__(self, quantum: int = 1 << 16, max_depth: int = 64,
                 max_inflight: int = 2):
        if quantum < 1 or max_depth < 1 or max_inflight < 1:
            raise ValueError("quantum, max_depth and max_inflight must be >= 1")
        self.quantum = int(quantum)
        self.max_depth = int(max_depth)
        self.max_inflight = int(max_inflight)
        self._lock = locksmith.make_lock("fairqueue")
        self._cond = locksmith.make_condition("fairqueue", self._lock)
        self._queues: Dict[str, deque] = {}        # tenant -> ops
        self._deficit: Dict[str, int] = {}
        self._inflight: Dict[str, int] = {}
        self._ring: List[str] = []                 # visit order
        self._cursor = 0
        self._closed = False
        self._paused = False
        # counters for --stats
        self.submitted = 0
        self.rejected_busy = 0
        self.dispatched = 0

    # -- tenant lifecycle ----------------------------------------------------
    def add_tenant(self, tenant: str) -> None:
        with self._lock:
            if tenant in self._queues:
                raise SessionError(f"tenant {tenant!r} already queued")
            self._queues[tenant] = deque()
            self._deficit[tenant] = 0
            self._inflight[tenant] = 0
            self._ring.append(tenant)

    def remove_tenant(self, tenant: str) -> list:
        """Drop a tenant (lease revoked): its queued-but-undispatched ops
        are returned so the caller can fail them; in-flight ops finish on
        the pool (they no longer involve the client)."""
        with self._lock:
            dropped = list(self._queues.pop(tenant, ()))
            self._deficit.pop(tenant, None)
            self._inflight.pop(tenant, None)
            if tenant in self._ring:
                idx = self._ring.index(tenant)
                self._ring.remove(tenant)
                if idx < self._cursor:
                    self._cursor -= 1
                if self._ring:
                    self._cursor %= len(self._ring)
                else:
                    self._cursor = 0
            self._cond.notify_all()
            return dropped

    # -- producer side -------------------------------------------------------
    def submit(self, op: Any) -> None:
        """Enqueue one op (needs ``.tenant`` and ``.nbytes``). Raises the
        retriable ServeBusyError when the tenant's queue is at depth."""
        with self._lock:
            q = self._queues.get(op.tenant)
            if q is None:
                raise SessionError(f"tenant {op.tenant!r} holds no lease")
            if len(q) >= self.max_depth:
                self.rejected_busy += 1
                raise ServeBusyError(
                    f"tenant {op.tenant!r} admission queue is full "
                    f"({len(q)}/{self.max_depth} queued) — retry after a "
                    f"backoff", tenant=op.tenant, depth=len(q))
            q.append(op)
            self.submitted += 1
            self._cond.notify_all()

    # -- consumer side (single dispatcher) ------------------------------------
    def _eligible(self, tenant: str) -> bool:
        q = self._queues.get(tenant)
        return bool(q) and self._inflight[tenant] < self.max_inflight

    def _try_pop(self) -> tuple[Optional[Any], bool]:
        """One full DRR sweep: (op, deficit_blocked). ``deficit_blocked``
        means some eligible tenant was held back only by credit — another
        sweep (which grants another quantum per visit) will dispatch it, so
        the caller must resweep rather than wait for a notify."""
        n = len(self._ring)
        blocked = False
        if self._paused:
            return None, False
        for _ in range(n):
            tenant = self._ring[self._cursor]
            self._cursor = (self._cursor + 1) % n
            if not self._eligible(tenant):
                continue
            q = self._queues[tenant]
            cost = max(1, int(getattr(q[0], "nbytes", 0)))
            # grant this visit's quantum, bounded so an idle tenant can't
            # bank unbounded credit and later monopolize the pool
            self._deficit[tenant] = min(self._deficit[tenant] + self.quantum,
                                        cost + self.quantum)
            if self._deficit[tenant] >= cost:
                self._deficit[tenant] -= cost
                op = q.popleft()
                self._inflight[tenant] += 1
                self.dispatched += 1
                return op, blocked
            blocked = True
        return None, blocked

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Next op in DRR order; blocks until one is dispatchable, the
        timeout expires (returns None), or the queue is closed (None)."""
        with self._lock:
            while True:
                if self._closed:
                    return None
                op, blocked = self._try_pop()
                if op is not None:
                    return op
                if blocked:
                    continue        # credit accrues per sweep, not per event
                if not self._cond.wait(timeout):
                    return None

    def complete(self, op: Any) -> None:
        """An op released its pool slot; its tenant may dispatch again."""
        with self._lock:
            if op.tenant in self._inflight:
                self._inflight[op.tenant] -= 1
            self._cond.notify_all()

    def pause(self) -> None:
        """Stop dispatching (submits still queue; nothing pops) — the
        quiesce half of the elastic rebind protocol. In-flight ops are the
        caller's to drain via :meth:`inflight_total`."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._cond.notify_all()

    def inflight_total(self) -> int:
        """Ops dispatched to the pool and not yet completed, across all
        tenants (0 = the pool is drained and safe to remap)."""
        with self._lock:
            return sum(self._inflight.values())

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._lock:
            return {
                "tenants": {t: {"queued": len(q),
                                "inflight": self._inflight.get(t, 0),
                                "deficit": self._deficit.get(t, 0)}
                            for t, q in self._queues.items()},
                "submitted": self.submitted,
                "rejected_busy": self.rejected_busy,
                "dispatched": self.dispatched,
                "quantum": self.quantum,
                "max_depth": self.max_depth,
                "max_inflight": self.max_inflight,
                "paused": self._paused,
            }


class ReadyRing:
    """The front door's ready-queue: connections with parsed frames
    waiting for a worker, FIFO with membership dedup (an item is in the
    ring at most once however many readiness events fire while it waits).
    FIFO across connections is round-robin service at the connection
    level — per-tenant byte fairness stays :class:`FairQueue`'s job at
    admission, this ring only keeps one chatty socket from being enqueued
    a thousand times ahead of everyone else.

    Items need a writable ``queued`` attribute (the dedup bit, owned by
    the ring). Any number of producers (the event loop, workers
    re-enqueueing) and consumers (the worker pool) may call concurrently.
    """

    def __init__(self, name: str = "frontdoor.ready"):
        self._lock = locksmith.make_lock(name)
        self._cond = locksmith.make_condition(name, self._lock)
        self._ring: deque = deque()
        self._closed = False

    def push(self, item: Any) -> bool:
        """Enqueue unless already queued; returns True when enqueued."""
        with self._lock:
            if self._closed or item.queued:
                return False
            item.queued = True
            self._ring.append(item)
            self._cond.notify()
            return True

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Next connection, blocking up to ``timeout``; None on timeout or
        close. The popped item's ``queued`` bit is cleared — a readiness
        event landing while a worker holds it re-enqueues it afresh."""
        with self._lock:
            while not self._ring:
                if self._closed:
                    return None
                if not self._cond.wait(timeout):
                    return None
            item = self._ring.popleft()
            item.queued = False
            return item

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()
