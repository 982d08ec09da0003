"""Host-side SPMD runtime: the TPU-native analog of libmpi's progress engine.

The reference launches N OS processes via mpiexec (MPI.jl bin/mpiexecjl:55-64)
and the external C libmpi provides message matching, collective rendezvous and
fate-sharing. On TPU the idiomatic model is a *single controller process* owning
all local devices, so this runtime executes N ranks as threads of one process:

- each rank is a thread with thread-local identity (``current_env``),
- point-to-point messages move zero-copy through per-rank :class:`Mailbox` objects
  with full MPI matching semantics (tags, ANY_SOURCE/ANY_TAG, non-overtaking order,
  Probe on unexpected messages) — the analog of libmpi's matching engine,
- collectives rendezvous through per-communicator :class:`CollectiveChannel`
  objects; the last rank to arrive performs the combine (data placement happens
  in shared memory / on device, so the "network" is a pointer exchange),
- a failure in any rank fate-shares the whole job (test/runtests.jl:37-39 asserts
  a single rank's error fails the run): every blocking wait polls the context's
  failure flag and raises :class:`~tpu_mpi_torch.error.AbortError`.

Multi-process (one process per host over DCN) reuses the same Mailbox/Channel
interfaces backed by the socket transport in ``tpu_mpi_torch.backend``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Callable, Optional, Sequence

from . import locksmith
from .error import (AbortError, CollectiveMismatchError, DeadlockError,
                    MPIError, ProcFailedError, RevokedError, SessionError)
from . import perfvars as _pv

# per-instance witness-name sequence for Mailbox/CollectiveChannel locks
_lock_seq = itertools.count(1)

# Wildcards / sentinels (values mirror the MPI spec's spirit; they are our own).
ANY_SOURCE = -2
ANY_TAG = -1
PROC_NULL = -3
UNDEFINED = -32766

_dt_cache: tuple = (None, -1, 60.0)     # (env raw, config generation, value)


def deadlock_timeout() -> float:
    """Seconds a blocking wait may stall before DeadlockError. Read per wait
    (env var first for test-time overrides, then the config module) so a
    runtime change takes effect without re-importing. Cached on the exact
    env string + config generation (P2P hot path: this runs once per
    blocking receive).

    When event tracing is on (config knob ``trace`` / env ``TPU_MPI_TRACE``),
    the raised DeadlockError carries the tpu_mpi_torch.analyze dump of per-rank
    pending operations and the wait-for cycle — see docs/analysis.md."""
    global _dt_cache
    from . import config
    raw = os.environ.get("TPU_MPI_DEADLOCK_TIMEOUT")
    craw, cgen, cval = _dt_cache
    if raw == craw and cgen == config.GENERATION:
        return cval
    val = None
    if raw is not None:
        try:
            val = float(raw)
        except ValueError:
            val = None
    if val is None:
        val = config.load().deadlock_timeout
    _dt_cache = (raw, config.GENERATION, val)
    return val


_ot_cache: tuple = (None, -1, 0.0)      # (env raw, config generation, value)


def op_timeout() -> float:
    """Per-op deadline in SECONDS (knob ``TPU_MPI_OP_TIMEOUT_MS``); 0 =
    disabled (the default). When set, every blocking recv / request Wait /
    collective wait clamps its budget to min(deadlock_timeout, this), so a
    silently dead peer fails the op loudly — with the per-rank pending-op
    dump — well before the 60 s deadlock budget. Cached like
    :func:`deadlock_timeout` (same hot path)."""
    global _ot_cache
    from . import config
    raw = os.environ.get("TPU_MPI_OP_TIMEOUT_MS")
    craw, cgen, cval = _ot_cache
    if raw == craw and cgen == config.GENERATION:
        return cval
    val = None
    if raw is not None:
        try:
            val = float(raw) / 1000.0
        except ValueError:
            val = None
    if val is None:
        val = config.load().op_timeout_ms / 1000.0
    _ot_cache = (raw, config.GENERATION, val)
    return val


def _default_wait_budget() -> float:
    """The budget of a wait that gave no explicit timeout/limit: the
    deadlock timeout, tightened by the op deadline when that knob is on."""
    budget = deadlock_timeout()
    ot = op_timeout()
    if ot > 0:
        budget = min(budget, ot)
    return budget


_POLL = 0.02


def raise_deadlock(ctx, msg: str) -> None:
    """Raise DeadlockError, appending the tpu_mpi_torch.analyze dump of per-rank
    pending operations + the wait-for cycle when tracing recorded one
    (docs/analysis.md). Never fails for a reason other than the deadlock."""
    try:
        from .analyze.matcher import deadlock_report
        report = deadlock_report(ctx)
    except Exception:
        report = ""
    if report:
        msg = f"{msg}\n{report}"
    raise DeadlockError(msg)


_tls = threading.local()


_process_env: Optional[tuple["SpmdContext", int]] = None


def current_env() -> Optional[tuple["SpmdContext", int]]:
    """Return (context, rank) for the calling thread, or None outside SPMD.

    Falls back to the process-global binding set by the multi-process tier:
    there a process IS one rank, so every thread of it may call MPI
    (THREAD_MULTIPLE semantics) without the explicit set_env attachment the
    thread-rank tier needs (where several ranks share one process)."""
    env = getattr(_tls, "env", None)
    return env if env is not None else _process_env


def set_env(env: Optional[tuple["SpmdContext", int]]) -> None:
    _tls.env = env


def set_process_env(env: Optional[tuple["SpmdContext", int]]) -> None:
    """Bind the whole process to one rank (multi-process tier only)."""
    global _process_env
    _process_env = env


def require_env() -> tuple["SpmdContext", int]:
    env = current_env()
    if env is None:
        raise MPIError("MPI has not been initialized on this thread; call Init() "
                       "or run under spmd_run()/tpurun")
    return env


def current_tenant() -> Optional[str]:
    """Tenant id the calling thread executes on behalf of (serve tier),
    or None for single-tenant / non-broker execution."""
    return getattr(_tls, "tenant", None)


def set_current_tenant(tenant: Optional[str]) -> None:
    """Bind the calling thread to a tenant (broker worker threads only:
    every cid allocated and every collective channel touched while bound is
    attributed to — and confined to — that tenant's leased namespace)."""
    _tls.tenant = tenant


class CidNamespace:
    """A tenant's disjoint slice of the communicator context-id space
    (docs/serving.md). ``alloc`` is the only mutation; exhaustion is a
    typed error rather than a silent spill into a neighbor's range."""

    __slots__ = ("tenant", "base", "limit", "_next", "_lock")

    def __init__(self, tenant: str, base: int, limit: int):
        self.tenant = tenant
        self.base = base          # first cid of the range (== the world cid)
        self.limit = limit        # one past the last usable cid
        self._next = base
        self._lock = locksmith.make_lock(f"ns[{tenant}]")

    def alloc(self) -> int:
        with self._lock:
            if self._next >= self.limit:
                raise SessionError(
                    f"tenant {self.tenant!r} exhausted its cid namespace "
                    f"[{self.base}, {self.limit}) — free communicators or "
                    f"lease a wider span")
            cid = self._next
            self._next += 1
            return cid

    def owns(self, cid: Any) -> bool:
        return isinstance(cid, int) and self.base <= cid < self.limit

    def __repr__(self) -> str:
        return (f"<CidNamespace {self.tenant} [{self.base},{self.limit}) "
                f"next={self._next}>")


_UNSET_CID = object()   # "derive fault_cid from the waitable" sentinel


class _Waitable:
    """Mixin: condition-variable wait loop with failure + deadlock checks."""

    ctx: "SpmdContext"
    cond: threading.Condition

    def _wait_for(self, pred: Callable[[], bool], what: str,
                  timeout: Optional[float] = None,
                  limit: Optional[float] = None,
                  fault_cid: Any = _UNSET_CID) -> bool:
        """Wait (cond held) until pred() or failure/deadlock. Returns pred().

        ``timeout`` makes expiry return False (Test*-style polling);
        ``limit`` overrides the deadlock budget but keeps the raising
        semantics (ops that legitimately outlast it, e.g. Comm_spawn's
        child-process rendezvous). ``fault_cid`` names the communicator for
        the revoked-comm fault surface; by default it is read off the
        waitable itself (channels carry a ``cid`` attribute)."""
        if timeout is not None:
            limit = timeout
        elif limit is None:
            limit = _default_wait_budget()
        deadline = time.monotonic() + limit
        if fault_cid is _UNSET_CID:
            fault_cid = getattr(self, "cid", None)
        while not pred():
            self.ctx.check_failure()
            self.ctx.check_fault(fault_cid)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if timeout is not None:
                    return False
                raise_deadlock(self.ctx,
                               f"deadlock suspected: blocked >{limit}s in {what}")
            self.cond.wait(min(_POLL, remaining))
        return True


def collective_wait_limit(opname: str) -> Optional[float]:
    """Per-op override of the deadlock budget: a Comm_spawn collective
    legitimately blocks while child processes boot (cold interpreter + torch
    import), so non-root ranks wait with the rendezvous budget, not the
    60 s deadlock one."""
    if opname.startswith("Comm_spawn"):
        from . import config
        return max(deadlock_timeout(), config.load().rendezvous_timeout)
    return None


def pump_wait(ctx, cond, pred: Callable[[], bool], what: str, *,
              timeout: Optional[float] = None,
              limit: Optional[float] = None,
              fault_cid: Any = None, fault: bool = True) -> bool:
    """Blocked-waiter loop driving the context's direct transport pump. The single implementation behind Mailbox receives,
    ProcChannel collective waits and RmaEngine response waits: cond's lock
    must be held exactly once on entry; the loop releases it around each
    pump so deliveries (which take the same lock) can land. Returns pred()
    — False only in ``timeout`` mode; raises DeadlockError past the budget
    otherwise; ``limit`` overrides the budget but keeps raising semantics.

    ``fault_cid`` names the communicator the wait belongs to (RevokedError
    surface); ``fault=False`` suppresses the fault checks entirely — the
    recovery protocol (Comm_agree/Comm_shrink) must keep communicating
    while peers are known dead."""
    if timeout is not None:
        budget = timeout
    elif limit is not None:
        budget = limit
    else:
        budget = _default_wait_budget()
    deadline = time.monotonic() + budget
    ctx._pump_begin()
    try:
        while not pred():
            ctx.check_failure()
            if fault:
                ctx.check_fault(fault_cid)
            if time.monotonic() >= deadline:
                if timeout is not None:
                    return False
                raise_deadlock(
                    ctx, f"deadlock suspected: blocked >{budget}s in {what}")
            cond.release()
            try:
                pumped = ctx._direct_pump(0.02, pred)
            finally:
                cond.acquire()
            if not pumped:
                # pump busy (a sibling holds the lease) or idle socket:
                # brief cond wait keeps us responsive to wakeups
                cond.wait(0.002)
    finally:
        ctx._pump_end()
    return True


class Message:
    """An in-flight point-to-point message (typed buffer or serialized object)."""

    __slots__ = ("src", "tag", "cid", "payload", "count", "dtype", "kind",
                 "seq")

    def __init__(self, src: int, tag: int, cid: int, payload: Any,
                 count: int, dtype: Any, kind: str,
                 seq: Optional[int] = None):
        self.src = src
        self.tag = tag
        self.cid = cid
        self.payload = payload
        self.count = count      # element count (typed) or byte length (object)
        self.dtype = dtype
        self.kind = kind        # "typed" | "object"
        self.seq = seq          # debug sequence-check stamp (None = off)


class PendingRecv:
    """A posted receive awaiting a matching message (Irecv/Recv)."""

    __slots__ = ("src", "tag", "cid", "msg", "done", "cancelled")

    def __init__(self, src: int, tag: int, cid: int):
        self.src = src
        self.tag = tag
        self.cid = cid
        self.msg: Optional[Message] = None
        self.done = False
        self.cancelled = False

    def matches(self, m: Message) -> bool:
        # ANY_TAG is a USER wildcard: it must not capture internal
        # tuple-tagged lanes (partitioned traffic uses ("part", tag) —
        # MPI-4 forbids partitioned transfers matching normal wildcard
        # receives). An explicit tuple tag still matches exactly.
        return (m.cid == self.cid
                and (self.src == ANY_SOURCE or self.src == m.src)
                and ((self.tag == ANY_TAG and not isinstance(m.tag, tuple))
                     or self.tag == m.tag))


class Mailbox(_Waitable):
    """Per-rank message matching engine.

    Preserves MPI non-overtaking order: messages are matched FIFO, posted
    receives are matched FIFO, and an incoming message first tries pending
    receives before landing on the unexpected queue (where Probe sees it).
    Mirrors the matching semantics the reference gets from libmpi
    (MPI.jl src/pointtopoint.jl:121-148, :271-346).
    """

    def __init__(self, ctx: "SpmdContext"):
        self.ctx = ctx
        # RLock: ctx.fail() may notify a condition whose lock the failing
        # thread itself holds (observed self-deadlock on collective mismatch).
        # Witness names are per-instance: two mailboxes' locks are distinct
        # order-graph nodes, not one shared node with self-edges.
        name = f"mailbox[{next(_lock_seq)}]"
        self.lock = locksmith.make_rlock(name)
        self.cond = locksmith.make_condition(name, self.lock)
        self.queue: list[Message] = []        # unexpected messages, FIFO
        self.recvs: list[PendingRecv] = []    # posted receives, FIFO
        self.queued_bytes = 0                 # unexpected-queue footprint
        self._seq_seen: dict = {}             # (src, cid) -> last debug seq
        # called (lock held) with queued_bytes after a queue removal; the
        # multi-process backend hangs its unchoke logic here — hooks must
        # not perform I/O (the lock is the drainer's delivery path)
        self.drain_hook: Optional[Callable[[int], None]] = None
        # called (lock held) when a receive is posted with no queued match:
        # the receiver is actively waiting, possibly for a choked sender's
        # message it cannot see — the backend unchokes everyone (restores
        # the posted-receive admission bypass across processes)
        self.pending_recv_hook: Optional[Callable[[], None]] = None
        # blocked-receiver direct drain: when set (the
        # multi-process backend's pump), a rank blocked in Recv/Wait/Probe
        # polls its own transport connection instead of condition-waiting
        # for the drainer thread — removing the drainer→mailbox→scheduler
        # hops from the small-message latency path. Signature:
        # pump(timeout_s) -> bool (whether a frame was delivered); must be
        # called WITHOUT the mailbox lock held. pump_begin/pump_end bracket
        # the whole wait: the backend parks its drainer thread in between,
        # so the waiting rank owns the socket and the drainer burns no CPU
        # (essential on small-core hosts).
        self.direct_pump: Optional[Callable[[float], bool]] = None
        self.pump_begin: Optional[Callable[[], None]] = None
        self.pump_end: Optional[Callable[[], None]] = None

    @staticmethod
    def _nbytes(msg: Message) -> int:
        nb = getattr(msg.payload, "nbytes", None)
        if nb is not None:
            return int(nb)
        return len(msg.payload) if isinstance(msg.payload, (bytes, bytearray)) else 0

    def post(self, msg: Message) -> None:
        """Deliver a message (called from the sender's thread)."""
        with self.cond:
            self._post_locked(msg)

    def post_blocking(self, msg: Message, what: str) -> None:
        """Deliver with flow control (libmpi's rendezvous-protocol
        analog): used by BLOCKING sends only — Isend
        keeps its buffered never-blocks semantics. Admit immediately when a
        posted receive matches (the message bypasses the unexpected queue),
        when the queue is empty (one oversized message always goes through),
        or when it fits under the high-water mark; otherwise wait. The check
        and the delivery happen under one lock hold, so concurrent senders
        serialize and cannot overshoot the mark together. A send that can
        never drain (receiver never posts a recv) surfaces as DeadlockError,
        which is exactly what that program is."""
        from . import config
        high = config.load().send_highwater_bytes
        with self.cond:
            if high > 0:
                nb = self._nbytes(msg)

                def admissible() -> bool:
                    if any(not pr.cancelled and pr.matches(msg)
                           for pr in self.recvs):
                        return True
                    return not self.queue or self.queued_bytes + nb <= high

                # Progress-aware deadlock budget: a receiver
                # that drains slowly-but-steadily is making progress, not
                # deadlocking — each observed shrink of the unexpected
                # queue restarts the budget (each _wait_for call takes a
                # fresh deadline). Only a genuinely stuck queue raises.
                floor = self.queued_bytes
                while not admissible():
                    self._wait_for(
                        lambda: admissible() or self.queued_bytes < floor,
                        f"{what} (destination unexpected-queue over "
                        f"high-water mark)")
                    floor = min(floor, self.queued_bytes)
            self._post_locked(msg)

    def _post_locked(self, msg: Message) -> None:
        if msg.seq is not None:
            # debug sequence check (SURVEY.md §5 race detection): every
            # sender stamps a per-(sender, cid) counter; delivery must see
            # it strictly increasing — a reordered/duplicated/lost frame in
            # any transport tier fails loudly here instead of corrupting
            # matching order silently.
            key = (msg.src, msg.cid)
            last = self._seq_seen.get(key, 0)
            if msg.seq != last + 1:
                err = MPIError(
                    f"P2P sequence violation from comm-rank {msg.src} "
                    f"cid {msg.cid}: got #{msg.seq} after #{last} "
                    f"(reordered, duplicated, or dropped message)")
                self.ctx.fail(err)
                raise err
            self._seq_seen[key] = msg.seq
        for pr in self.recvs:
            if not pr.cancelled and pr.matches(msg):
                self.recvs.remove(pr)
                pr.msg = msg
                pr.done = True
                self.cond.notify_all()
                return
        self.queue.append(msg)
        self.queued_bytes += self._nbytes(msg)
        self.cond.notify_all()

    def _match_or_subscribe_locked(self, pr: PendingRecv) -> bool:
        """Match pr against the unexpected queue (oldest first) or append
        it to the posted-receive list. True = matched now (pr.msg set).
        Caller holds the lock; shared by post_recv and recv_blocking so
        the blocking and nonblocking paths cannot diverge."""
        for m in self.queue:
            if pr.matches(m):
                self.queue.remove(m)
                self.queued_bytes -= self._nbytes(m)
                pr.msg = m
                pr.done = True
                self.cond.notify_all()       # senders blocked on capacity
                if self.drain_hook is not None:
                    self.drain_hook(self.queued_bytes)
                return True
        self.recvs.append(pr)
        if self.pending_recv_hook is not None:
            self.pending_recv_hook()
        return False

    def post_recv(self, src: int, tag: int, cid: int) -> PendingRecv:
        """Post a receive; matches the oldest queued message first (Irecv!)."""
        pr = PendingRecv(src, tag, cid)
        with self.cond:
            self._match_or_subscribe_locked(pr)
        return pr

    def _wait_for_rx(self, pred: Callable[[], bool], what: str,
                     cid: Any = None) -> None:
        """Receive-side wait (cond held on entry): like _wait_for, but when
        the backend provides :attr:`direct_pump`, this thread drains its own
        transport connection while it waits — no drainer hop. Falls back to
        a short condition wait whenever the pump is busy (the drainer or a
        sibling thread holds it), so THREAD_MULTIPLE receivers and the
        drainer interleave safely. ``cid`` names the communicator for the
        revoked-comm fault surface."""
        if self.direct_pump is None:
            self._wait_for(pred, what, fault_cid=cid)
            return
        pump_wait(self.ctx, self.cond, pred, what, fault_cid=cid)

    def _await_locked(self, pr: PendingRecv) -> Optional[Message]:
        """Wait for pr under the held lock; returns None if cancelled.
        Shared tail of wait_recv and recv_blocking."""
        self._wait_for_rx(lambda: pr.done or pr.cancelled, "Recv/Wait",
                          cid=pr.cid)
        if pr.cancelled and not pr.done:
            if pr in self.recvs:
                self.recvs.remove(pr)
            return None
        return pr.msg

    def wait_recv(self, pr: PendingRecv) -> Optional[Message]:
        """Block until pr completes (Wait!); returns None if cancelled."""
        with self.cond:
            return self._await_locked(pr)

    def recv_blocking(self, src: int, tag: int, cid) -> Optional[Message]:
        """Blocking-receive fast path: post_recv + wait_recv fused into ONE
        lock entry (the small-message latency lane — a second lock round
        trip per message is measurable on 1-core hosts). Semantically
        identical to post_recv followed by wait_recv; blocking receives
        expose no cancel handle, so None is only a failure surface."""
        with self.cond:
            # exact-(src, tag) head match: the already-arrived case (the
            # receiver runs behind the sender) completes with no PendingRecv
            # allocation and no matches() calls. Only the queue HEAD is
            # eligible — FIFO matching means an exact receive may not
            # overtake an older queued message it also matches.
            if self.queue and src >= 0 and not isinstance(tag, tuple):
                m = self.queue[0]
                if m.cid == cid and m.src == src and m.tag == tag:
                    self.queue.pop(0)
                    self.queued_bytes -= self._nbytes(m)
                    self.cond.notify_all()   # senders blocked on capacity
                    if self.drain_hook is not None:
                        self.drain_hook(self.queued_bytes)
                    return m
            pr = PendingRecv(src, tag, cid)
            if self._match_or_subscribe_locked(pr):
                return pr.msg
            return self._await_locked(pr)

    def test_recv(self, pr: PendingRecv) -> bool:
        with self.cond:
            return pr.done or pr.cancelled

    def cancel(self, pr: PendingRecv) -> None:
        """Cancel a posted receive (src/pointtopoint.jl:677-681)."""
        with self.cond:
            if not pr.done:
                pr.cancelled = True
                if pr in self.recvs:
                    self.recvs.remove(pr)
                self.cond.notify_all()

    def probe(self, src: int, tag: int, cid: int, block: bool) -> Optional[Message]:
        """Find (without removing) a matching unexpected message (Probe/Iprobe)."""
        probe_pr = PendingRecv(src, tag, cid)
        with self.cond:
            def find() -> Optional[Message]:
                for m in self.queue:
                    if probe_pr.matches(m):
                        return m
                return None
            if not block:
                return find()
            self._wait_for_rx(lambda: find() is not None, "Probe", cid=cid)
            return find()

    def notify(self) -> None:
        with self.cond:
            self.cond.notify_all()


_EMPTY = object()   # distinct "no contribution yet" marker (None is a valid payload)


class CollectiveChannel(_Waitable):
    """Reusable all-rank rendezvous for one communicator, ROUND-KEYED.

    Every collective round: each rank deposits a contribution; the last
    arriver runs ``combine(contribs) -> per-rank results`` (doing any data
    placement — all buffers are visible in the shared address space / on
    device); every rank picks up its slot.

    Rounds are numbered per rank and rendezvous state lives in a per-round
    slot (the multi-process ``ProcChannel`` round-counter pattern), so a
    rank that picked its round-k result enters round k+1 IMMEDIATELY —
    no wait for slow peers to drain round k. The original single-slot
    design paid two full condition barriers per op (previous-round drain +
    last-picker reset); head-of-line blocking across back-to-back ops was
    the largest share of the host-lane dispatch overhead (
    ``BENCH_r05.json`` host_lane.overhead_ms). At most two rounds are ever
    live: round k+1 cannot complete its rendezvous before every rank
    arrived in it, which requires every rank to have picked (and thereby
    freed) round k.

    The ``opname`` tag is checked across ranks every round — calling
    mismatched collectives on one communicator raises
    CollectiveMismatchError in all ranks instead of deadlocking (SURVEY.md
    §5 "race detection").
    """

    def __init__(self, ctx: "SpmdContext", size: int):
        self.ctx = ctx
        self.size = size
        # see Mailbox.__init__ on reentrancy + per-instance witness names
        name = f"channel[{next(_lock_seq)}]"
        self.lock = locksmith.make_rlock(name)
        self.cond = locksmith.make_condition(name, self.lock)
        # per-rank next-round counters + live per-round rendezvous slots
        self.rank_round = [0] * size
        self.rounds: dict[int, dict] = {}

    def _round_state(self, rnd: int) -> dict:
        st = self.rounds.get(rnd)
        if st is None:
            st = self.rounds[rnd] = {
                "contribs": [_EMPTY] * self.size, "arrived": 0,
                "results": None, "picked": 0, "opname": None}
        return st

    def run(self, rank: int, contrib: Any, combine: Callable[[list[Any]], Sequence[Any]],
            opname: str, plan=None, unlocked_fold: bool = False) -> Any:
        # ``plan`` (an algorithm hint for the multi-process tier) is ignored
        # here: threads share an address space, so the combine-in-place star
        # IS the optimal algorithm — data placement is a pointer exchange.
        #
        # ``unlocked_fold`` (registered fast path): the last arriver runs the
        # combine with the channel lock RELEASED. Safe exactly then: the
        # combine folds into a plan-private registered scratch (no shared
        # rendezvous state touched), all peer ranks of THIS round are parked
        # in cond.wait, and no rank can arrive in round k+1 before picking
        # round k — so nothing else can mutate the round slot while the lock
        # is down, and waiters, P2P progress and other communicators never
        # contend with a long fold for the condvar.
        self.cond.acquire()
        try:
            rnd = self.rank_round[rank]
            self.rank_round[rank] += 1
            st = self._round_state(rnd)
            if st["opname"] is None:
                st["opname"] = opname
            elif st["opname"] != opname:
                err = CollectiveMismatchError(
                    f"rank {rank} called {opname!r} while other ranks are in "
                    f"{st['opname']!r} on the same communicator")
                self.ctx.fail(err)
                raise err
            st["contribs"][rank] = contrib
            st["arrived"] += 1
            # pvar phase spans: last arriver's combine is the fold; every
            # other rank's block below is the rendezvous. One TLS read when
            # no scope is open (pvars and tracing both off).
            sc = _pv.scope()
            if st["arrived"] == self.size:
                contribs = list(st["contribs"])
                t0 = _pv.monotonic() if sc is not None else 0.0
                try:
                    if unlocked_fold:
                        self.cond.release()
                        try:
                            results = list(combine(contribs))
                        finally:
                            self.cond.acquire()
                    else:
                        results = list(combine(contribs))
                except BaseException as e:
                    self.ctx.fail(e)
                    raise
                if sc is not None:
                    sc.spans.append(("fold", t0, _pv.monotonic()))
                if len(results) != self.size:
                    err = MPIError(f"combine for {opname} returned {len(results)} "
                                   f"results for {self.size} ranks")
                    self.ctx.fail(err)
                    raise err
                st["results"] = results
                st["contribs"] = []      # contributions are dead: release refs
                self.cond.notify_all()
            else:
                t0 = _pv.monotonic() if sc is not None else 0.0
                self._wait_for(lambda: st["results"] is not None,
                               f"collective {opname}",
                               limit=collective_wait_limit(opname))
                if sc is not None:
                    sc.spans.append(("rendezvous", t0, _pv.monotonic()))
            res = st["results"][rank]
            st["picked"] += 1
            if st["picked"] == self.size:
                self.rounds.pop(rnd, None)   # fully drained; no reset barrier
            return res
        finally:
            self.cond.release()

    def run_batch(self, rank: int, ops: Sequence[tuple]) -> list:
        """Deposit K queued collective rounds through ONE lock acquisition
        and ONE wakeup (batched submission), then collect each
        round's result in Start order. ``ops`` is a sequence of
        ``(contrib, combine, opname, unlocked_fold)`` tuples.

        Correctness rides on the same round-keyed slots as :meth:`run`:
        each round's slot is independent, a round folds only once ALL
        ranks arrived in it, and folds serialize through the slowest
        depositor — a rank cannot complete round r+1 before every rank
        (including any rank still folding round r) deposited it. A
        batching rank pairs correctly with peers running the same rounds
        one ``run`` at a time: rounds are numbered per rank, not per call
        style. The ``run`` docstring's "at most two rounds live" bound
        relaxes to "at most two plus the largest in-flight batch"."""
        n = len(ops)
        if n == 0:
            return []
        if n == 1:
            contrib, combine, opname, ufold = ops[0]
            return [self.run(rank, contrib, combine, opname,
                             unlocked_fold=ufold)]
        sc = _pv.scope()
        deposited = []          # (rnd, st, opname) in Start order
        self.cond.acquire()
        try:
            fold_pending = False
            for contrib, combine, opname, ufold in ops:
                rnd = self.rank_round[rank]
                self.rank_round[rank] += 1
                st = self._round_state(rnd)
                if st["opname"] is None:
                    st["opname"] = opname
                elif st["opname"] != opname:
                    err = CollectiveMismatchError(
                        f"rank {rank} called {opname!r} while other ranks "
                        f"are in {st['opname']!r} on the same communicator")
                    self.ctx.fail(err)
                    raise err
                st["contribs"][rank] = contrib
                st["arrived"] += 1
                if st["arrived"] == self.size:
                    contribs = list(st["contribs"])
                    t0 = _pv.monotonic() if sc is not None else 0.0
                    try:
                        if ufold:
                            # safe for the same reason as in run(): this
                            # round's slot can take no more deposits
                            # (arrived == size) and waiters re-check
                            # results only under the lock
                            self.cond.release()
                            try:
                                results = list(combine(contribs))
                            finally:
                                self.cond.acquire()
                        else:
                            results = list(combine(contribs))
                    except BaseException as e:
                        self.ctx.fail(e)
                        raise
                    if sc is not None:
                        sc.spans.append(("fold", t0, _pv.monotonic()))
                    if len(results) != self.size:
                        err = MPIError(
                            f"combine for {opname} returned {len(results)} "
                            f"results for {self.size} ranks")
                        self.ctx.fail(err)
                        raise err
                    st["results"] = results
                    st["contribs"] = []
                    fold_pending = True
                deposited.append((rnd, st, opname))
            if fold_pending:
                self.cond.notify_all()   # one wakeup for the whole batch
            out = []
            for rnd, st, opname in deposited:
                if st["results"] is None:
                    t0 = _pv.monotonic() if sc is not None else 0.0
                    self._wait_for(lambda st=st: st["results"] is not None,
                                   f"collective {opname}",
                                   limit=collective_wait_limit(opname))
                    if sc is not None:
                        sc.spans.append(
                            ("rendezvous", t0, _pv.monotonic()))
                out.append(st["results"][rank])
                st["picked"] += 1
                if st["picked"] == self.size:
                    self.rounds.pop(rnd, None)
            return out
        finally:
            self.cond.release()


class SpmdContext:
    """State shared by all ranks of one SPMD job (the "world").

    Analog of what mpiexec + libmpi set up before/at MPI_Init
    (MPI.jl src/environment.jl:80-89): fixed world size, per-rank
    mailboxes, communicator context-id allocation, and fate-sharing.
    """

    def __init__(self, size: int, universe_size: Optional[int] = None):
        if size < 1:
            raise ValueError("world size must be >= 1")
        self.size = size
        self.universe_size = universe_size if universe_size is not None else size
        self.mailboxes = [Mailbox(self) for _ in range(size)]
        self._channels: dict[int, CollectiveChannel] = {}
        self._channels_lock = locksmith.make_lock("ctx.channels")
        # cid 0 = COMM_WORLD, 1 = COMM_SELF; dynamic cids start at 2.
        self._next_cid = itertools.count(2)
        self.failure: Optional[BaseException] = None
        self.failed_rank: Optional[int] = None
        self._failure_lock = locksmith.make_lock("ctx.failure")
        # ULFM fault state (docs/fault-tolerance.md): world ranks the
        # failure detector declared dead, ranks that left cleanly (Finalize
        # with detection on — NOT failures), and revoked communicator cids.
        # All empty in the default fault-free configuration; check_fault is
        # then two truth tests per wait iteration.
        self.failed_ranks: set[int] = set()
        self.departed_ranks: set[int] = set()
        self.revoked_cids: set = set()
        # Multi-tenant serve tier (docs/serving.md): tenant -> leased cid
        # namespace. Empty outside a broker — the cross-tenant channel guard
        # is then a single truth test (pay-for-use, like the fault path).
        self.cid_namespaces: dict[str, CidNamespace] = {}
        self._ns_lock = locksmith.make_lock("ctx.ns")
        self._ns_next_base = 1 << 20   # far above itertools.count(2)'s reach
        # Per-rank lifecycle flags (src/environment.jl:267-287 queries).
        self.initialized = [False] * size
        self.finalized = [False] * size
        self.thread_level = [None] * size
        self.main_threads: list[Optional[int]] = [None] * size
        # Attribute store for windows/files keyed by (kind, id).
        self.objects: dict[Any, Any] = {}
        self.objects_lock = locksmith.make_lock("ctx.objects")
        # Dynamic process management (src/comm.jl:123-162): each world rank
        # belongs to a "job world" — its own COMM_WORLD group + context id.
        # Spawned groups get a fresh world (MPI gives spawned jobs their own
        # MPI_COMM_WORLD); the parent side sees them only via the intercomm.
        self.worlds: dict[int, tuple[tuple[int, ...], Any]] = {
            r: (tuple(range(size)), 0) for r in range(size)}
        self.parent_comm: dict[int, Any] = {}     # spawned rank -> intercomm
        self.spawn_argv: dict[int, list] = {}     # spawned rank -> its argv
        # debug sequence-check counters: (dest_world, cid, src_comm_rank)
        self._seq_counters: dict = {}
        self._seq_lock = locksmith.make_lock("ctx.seq")
        self.spawned_threads: list[threading.Thread] = []
        self._spawn_lock = locksmith.make_lock("ctx.spawn")

    @property
    def host_token(self) -> str:
        """Identity of the shared-memory domain this rank lives in
        (src/comm.jl:107-115 MPI_COMM_TYPE_SHARED semantics). All
        rank-threads of one controller process trivially share memory; the
        multi-process context overrides this with the rank's transport
        address host (or the TPU_MPI_HOST_ID override)."""
        return "local"

    # -- failure fate-sharing ------------------------------------------------
    def fail(self, exc: BaseException, rank: Optional[int] = None) -> None:
        with self._failure_lock:
            if self.failure is None:
                self.failure = exc
                self.failed_rank = rank
        for mb in self.mailboxes:
            mb.notify()
        with self._channels_lock:
            chans = list(self._channels.values())
        for ch in chans:
            with ch.cond:
                ch.cond.notify_all()

    def check_failure(self) -> None:
        if self.failure is not None:
            raise AbortError(
                f"job aborted ({type(self.failure).__name__}: {self.failure})"
                + (f" originating on rank {self.failed_rank}" if self.failed_rank is not None else ""))

    # -- ULFM fault surface (docs/fault-tolerance.md) -------------------------
    def _notify_waiters(self) -> None:
        """Wake every blocked wait loop so it re-runs its fault checks."""
        for mb in self.mailboxes:
            mb.notify()
        with self._channels_lock:
            chans = list(self._channels.values())
        for ch in chans:
            with ch.cond:
                ch.cond.notify_all()

    def peer_failed(self, rank: int) -> None:
        """Record a peer's death (failure-detector verdict: heartbeat
        silence past the timeout, or a closed/refused transport socket) and
        wake all waiters — they raise ProcFailedError instead of hanging."""
        if rank in self.failed_ranks:
            return
        with self._failure_lock:
            self.failed_ranks.add(rank)
        self._notify_waiters()

    def peer_departed(self, rank: int) -> None:
        """Record a peer's CLEAN exit (it announced Finalize before closing
        its sockets); the detector must not count it as a failure."""
        self.departed_ranks.add(rank)

    def revoke_comm(self, cid) -> None:
        """Mark a communicator revoked; every pending and future op on it
        raises RevokedError deterministically (Comm_revoke's local half)."""
        if cid in self.revoked_cids:
            return
        self.revoked_cids.add(cid)
        self._notify_waiters()

    def check_fault(self, cid=None) -> None:
        """Raise the typed ULFM error for the current fault state:
        RevokedError when the op's communicator was revoked, ProcFailedError
        when the failure detector has declared a peer of the op's
        communicator dead. When the communicator's group is known (its
        collective channel exists — Comm_shrink registers one eagerly), only
        deaths INSIDE the group raise, so a shrunk survivor communicator
        keeps operating after the failure; with no group to consult the
        check is pessimistic. The recovery protocol itself
        (Comm_agree/Comm_shrink) bypasses this check."""
        if self.revoked_cids and cid is not None and cid in self.revoked_cids:
            raise RevokedError(
                f"communicator (cid={cid}) was revoked after a failure; "
                f"only Comm_shrink/Comm_agree remain legal on it")
        if self.failed_ranks:
            if isinstance(cid, tuple) and cid and cid[0] == "ftagree":
                # the recovery protocol's own rendezvous: agreement must
                # complete DESPITE declared failures, or Comm_shrink could
                # never run. (The thread tier conscripts the declared-dead
                # rank's still-live thread through it; the process tier
                # replaces this channel with the coordinator protocol.)
                return
            dead = sorted(self.failed_ranks)
            if cid is not None:
                ch = self._channels.get(cid)
                group = getattr(ch, "group", None) if ch is not None else None
                if group:
                    dead = sorted(self.failed_ranks & set(group))
                    if not dead:
                        return      # every dead rank is outside this comm
            raise ProcFailedError(
                f"peer process(es) {dead} failed (heartbeat timeout or "
                f"closed transport socket); Comm_revoke + Comm_shrink to "
                f"continue on the survivors", ranks=dead)

    def ft_agree(self, me: int, group, cid, epoch: int,
                 flag: int) -> tuple[int, frozenset]:
        """Fault-tolerant agreement (Comm_agree/Comm_shrink substrate):
        bitwise-AND of every live member's ``flag`` plus the union of their
        failed-set views. Threads of one process cannot die independently,
        so here it is an ordinary rendezvous — on a DEDICATED cid, because
        agreement must still work on a revoked communicator (the channel of
        a revoked cid raises RevokedError from its wait loop). The
        multi-process backend overrides this with a coordinator protocol
        that survives concurrent failures."""
        group = tuple(group)
        ch = self.channel(("ftagree", cid), len(group), group)

        def combine(contribs):
            value = ~0
            dead: set = set()
            for f, d in contribs:
                value &= f
                dead |= set(d)
            return [(value, frozenset(dead & set(group)))] * len(contribs)

        # opname deliberately excludes ``epoch``: the world Comm object is
        # SHARED by rank threads, so its epoch counter can interleave — the
        # channel's round counter already sequences successive agreements
        return ch.run(group.index(me),
                      (int(flag), frozenset(self.failed_ranks & set(group))),
                      combine, f"Comm_agree@{cid}")

    # -- communicator context ids -------------------------------------------
    def alloc_cid(self) -> int:
        """Allocate a fresh communicator context id (call from combine only,
        so all members of the parent communicator agree on the value). A
        thread bound to a tenant (broker worker) allocates from that
        tenant's leased namespace so Comm_dup/Comm_split stay in-range."""
        tenant = current_tenant()
        if tenant is not None:
            ns = self.cid_namespaces.get(tenant)
            if ns is None:
                raise SessionError(
                    f"tenant {tenant!r} has no leased cid namespace on this "
                    f"world (lease revoked?)")
            return ns.alloc()
        return next(self._next_cid)

    # -- tenant cid namespaces (serve tier, docs/serving.md) ------------------
    def lease_cid_namespace(self, tenant: str, span: int = 256) -> CidNamespace:
        """Carve a disjoint cid range for a tenant. Ranges start far above
        the sequential allocator so the two can never collide."""
        if span < 1:
            raise MPIError(f"cid namespace span must be >= 1, got {span}")
        with self._ns_lock:
            if tenant in self.cid_namespaces:
                raise SessionError(f"tenant {tenant!r} already holds a lease "
                                   f"on this world")
            base = self._ns_next_base
            self._ns_next_base += span
            ns = CidNamespace(tenant, base, base + span)
            self.cid_namespaces[tenant] = ns
            return ns

    def namespace_of_cid(self, cid: Any) -> Optional[CidNamespace]:
        """The namespace owning a cid, or None for shared/pool cids. Tuple
        cids (internal channels like ftagree) are keyed by their embedded
        numeric cid."""
        if isinstance(cid, tuple):
            cid = next((c for c in cid if isinstance(c, int)), None)
        if not isinstance(cid, int) or cid < (1 << 20):
            return None
        for ns in self.cid_namespaces.values():
            if ns.owns(cid):
                return ns
        return None

    def release_cid_namespace(self, tenant: str) -> list:
        """Revoke a tenant's lease: drop its namespace and drain every
        collective channel in its range (lease reclamation — the cids are
        dead; a straggler op on one raises rather than rendezvousing with
        nobody). Returns the drained cids."""
        with self._ns_lock:
            ns = self.cid_namespaces.pop(tenant, None)
        if ns is None:
            return []
        drained = []
        with self._channels_lock:
            for key in list(self._channels):
                cid = key
                if isinstance(cid, tuple):
                    cid = next((c for c in cid if isinstance(c, int)), None)
                if isinstance(cid, int) and ns.owns(cid):
                    ch = self._channels.pop(key)
                    drained.append(key)
                    drop = getattr(ch, "drop_shm", None)
                    if drop is not None:
                        try:
                            drop()
                        except Exception:
                            pass
        # every cid the tenant ever allocated is dead, channel or not — a
        # straggler op on one must raise (RevokedError), not rendezvous
        # with nobody and hang
        self.revoked_cids.update(range(ns.base, ns._next))
        self._notify_waiters()
        return drained

    def check_tenant_cid(self, cid: Any) -> None:
        """Cross-tenant isolation guard (pay-for-use: callers skip it while
        ``cid_namespaces`` is empty). A cid inside some tenant's leased
        range may only be touched by threads bound to that tenant."""
        ns = self.namespace_of_cid(cid)
        if ns is None:
            return
        tenant = current_tenant()
        if tenant != ns.tenant:
            raise SessionError(
                f"cid {cid} belongs to tenant {ns.tenant!r}; "
                + (f"caller is tenant {tenant!r}" if tenant is not None
                   else "caller holds no lease")
                + " — cross-tenant communicator use is forbidden")

    def channel(self, cid: int, size: int,
                group: Optional[tuple[int, ...]] = None) -> CollectiveChannel:
        # `group` (world ranks, comm order) is unused here — threads share an
        # address space — but the multi-process backend needs it for routing.
        if self.cid_namespaces:          # serve tier only; else one truth test
            self.check_tenant_cid(cid)
        with self._channels_lock:
            ch = self._channels.get(cid)
            if ch is None:
                ch = CollectiveChannel(self, size)
                # identity for diagnostics (analyze.matcher reads the live
                # contribs to name missing ranks in the deadlock dump)
                ch.cid = cid
                ch.group = group
                self._channels[cid] = ch
            return ch

    # -- dynamic process management -----------------------------------------
    def world_of(self, rank: int) -> tuple[tuple[int, ...], Any]:
        """(group, cid) of the COMM_WORLD the given world rank belongs to."""
        return self.worlds[rank]

    def add_ranks(self, n: int, world_cid: Any) -> tuple[int, ...]:
        """Extend the job with ``n`` new ranks forming their own world.
        Called from a spawn rendezvous combiner (single thread)."""
        with self._spawn_lock:
            start = len(self.mailboxes)
            new = tuple(range(start, start + n))
            for r in new:
                self.mailboxes.append(Mailbox(self))
                self.initialized.append(False)
                self.finalized.append(False)
                self.thread_level.append(None)
                self.main_threads.append(None)
                self.worlds[r] = (new, world_cid)
            return new

    def start_rank_thread(self, rank: int, body: Callable[[], Any]) -> None:
        """Run ``body`` as a new rank thread with fate-sharing."""
        def runner() -> None:
            set_env((self, rank))
            try:
                body()
            except BaseException as e:
                self.fail(e, rank)
            finally:
                set_env(None)

        t = threading.Thread(target=runner, name=f"tpu-mpi-spawned-{rank}",
                             daemon=True)
        self.spawned_threads.append(t)
        t.start()

    # -- device binding ------------------------------------------------------
    def device_for(self, rank: int):
        """The CUDA device owned by a rank (rank i ↔ card i, wrapping: every
        rank shares the one card of a one-card host)."""
        import torch
        return torch.device("cuda", rank % torch.cuda.device_count())


class FailureDetector:
    """Python half of the failure detector (docs/fault-tolerance.md).

    The native transport emits heartbeat frames from its poll loop and
    tracks per-peer last-heard stamps (``tm_hb_enable``/``tm_peer_age_ms``);
    this class turns those raw ages into verdicts: a peer silent past the
    failure timeout — or whose socket closed / refused a heartbeat — is
    declared dead via ``ctx.peer_failed``. Instantiated by the multi-process
    backend only when ``TPU_MPI_HEARTBEAT_MS`` > 0; :meth:`poll` is
    rate-limited to one sweep per heartbeat period and is driven from the
    backend's drainer loop (and from direct-pump waiters), so detection
    works no matter which thread owns the transport lease."""

    def __init__(self, ctx, transport, heartbeat_ms: int,
                 failure_timeout_ms: int = 0):
        self.ctx = ctx
        self.transport = transport
        self.heartbeat_ms = int(heartbeat_ms)
        # 0 derives a conservative default: 10 beats of silence, >= 1 s
        self.timeout_ms = int(failure_timeout_ms) or max(
            10 * self.heartbeat_ms, 1000)
        self._interval = max(self.heartbeat_ms / 1000.0, 0.01)
        self._last_poll = 0.0
        transport.hb_enable(self.heartbeat_ms)

    def poll(self) -> None:
        """One rate-limited liveness sweep; cheap no-op between periods."""
        now = time.monotonic()
        if now - self._last_poll < self._interval:
            return
        self._last_poll = now
        ctx, tr = self.ctx, self.transport
        for peer in range(tr.size):
            if (peer == tr.rank or peer in ctx.failed_ranks
                    or peer in ctx.departed_ranks):
                continue
            age = tr.peer_age_ms(peer)
            if age == -2 or age > self.timeout_ms:
                # flight recorder: the verdict itself is the crash-grade
                # event — record it (and dump) before the declaration
                # cascades into ProcFailedError raises on blocked waiters
                from . import flight
                flight.note("peer_declared_dead", peer=peer,
                            age_ms=int(age), timeout_ms=self.timeout_ms)
                flight.auto_dump("peer-failed")
                ctx.peer_failed(peer)


_cuda_warmed = False
_warm_lock = threading.Lock()


def _warm_cuda_backend() -> None:
    """Initialize CUDA once, serially, before rank threads start: the
    context, the caching allocator and the kernel libraries (the fold and
    the rings, built at first use). Rank threads then never race to
    first-initialize any of them — the launcher owns backend bring-up, like
    mpiexec owns process bring-up in the reference. Without CUDA there is
    nothing to warm."""
    global _cuda_warmed
    with _warm_lock:
        if _cuda_warmed:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.init()
            torch.empty(1, device="cuda")
            from .kernels import _build, fused_reduce, ring
            libs = (fused_reduce.LIBRARY, ring.LIBRARY)
            _build.build_all(libs)
            for lib in libs:
                lib.load()
        _cuda_warmed = True


def spmd_run(fn: Callable[[], Any], size: int, *, args: tuple = (),
             universe_size: Optional[int] = None,
             timeout: Optional[float] = None) -> list[Any]:
    """Run ``fn()`` as an SPMD program on ``size`` ranks (threads).

    The TPU-native mpiexec: where the reference forks N OS processes
    (MPI.jl bin/mpiexecjl:55-64, test/runtests.jl:28-45), we run N rank
    threads in one controller process sharing the CUDA context. Returns the list
    of per-rank return values; re-raises the first rank failure (so a failing
    rank fails the whole run, matching test/runtests.jl:37-39).
    """
    _warm_cuda_backend()
    ctx = SpmdContext(size, universe_size=universe_size)
    results: list[Any] = [None] * size
    first_error: list[Optional[BaseException]] = [None]
    error_lock = threading.Lock()

    def runner(rank: int) -> None:
        set_env((ctx, rank))
        try:
            results[rank] = fn(*args)
        except BaseException as e:
            with error_lock:
                if first_error[0] is None:
                    first_error[0] = e
            ctx.fail(e, rank)
        finally:
            set_env(None)

    threads = [threading.Thread(target=runner, args=(r,), name=f"tpu-mpi-rank-{r}",
                                daemon=True) for r in range(size)]
    for t in threads:
        t.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    for t in threads:
        t.join(None if deadline is None else max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            ctx.fail(DeadlockError("spmd_run timeout"), None)
    for t in threads:
        t.join(5.0)
    # Ranks added by Comm_spawn must finish before the job is done. Spawned
    # ranks may spawn further ranks, so re-snapshot until the list drains.
    joined: set = set()
    while True:
        pending = [t for t in list(ctx.spawned_threads) if t not in joined]
        if not pending:
            break
        for t in pending:
            t.join(None if deadline is None else max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                ctx.fail(DeadlockError("spawned rank did not finish"), None)
                t.join(5.0)
            joined.add(t)
    # plans armed on communicators that were never freed (COMM_WORLD among
    # them) die with the run
    from .overlap import registry
    registry.release_world(ctx)
    err = first_error[0]
    if err is None and ctx.failure is not None:
        # e.g. a rank stuck in pure compute past the timeout: the failure was
        # recorded on the context but no rank thread surfaced it.
        err = ctx.failure
    if err is not None:
        raise err
    return results
