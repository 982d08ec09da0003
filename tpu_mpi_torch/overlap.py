"""Host-path overlap engine: chunk schedules, persistent collective plans,
and in-flight progress state.

Three coordinated pieces, shared by the thread tier (``_runtime
.CollectiveChannel``), the multi-process tier (``backend.ProcChannel``'s
chunked star) and the nonblocking machinery (``collective._nb_submit``):

- :class:`ChunkSchedule` — how a bulk payload splits into K pipeline chunks
  (``config.pipeline_min_bytes`` / ``config.pipeline_chunks``, the
  ``shm_min_bytes`` knob pattern). Chunking is only ever applied to
  elementwise rank-order folds, where it is *chunk-separable*: the pipelined
  result is bitwise-identical to the monolithic one.
- :class:`PlanCache` / :class:`CollectivePlan` — repeated same-shape
  collectives (the training-loop case) resolve their op, combine closure,
  opname tag, trace signature and chunk schedule ONCE and reuse the plan;
  keyed on (comm, op, dtype, shape, flavor) and invalidated by
  ``Comm.free`` and by config reloads (``config.GENERATION``).
- :class:`ChunkProgress` — per-request in-flight chunk state that the
  progress threads (the per-comm nonblocking worker; the multi-process
  drainer feeding it) advance while the rank thread is in user code, and
  that ``Wait``/``Test`` join instead of executing the whole op.

:class:`PersistentCollRequest` is the persistent-collective handle behind
``Allreduce_init``-style APIs (MPI-4 persistent collectives), mirroring the
persistent P2P machinery (:class:`tpu_mpi_torch.pointtopoint.Prequest`).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Optional

from . import error as _ec
from . import locksmith
from .error import MPIError


class ChunkSchedule:
    """A bulk payload's split into pipeline chunks.

    ``bounds`` is a list of flat-element ``(lo, hi)`` half-open ranges
    covering ``[0, count)`` in order. Every chunk has ``base`` elements and
    the LAST chunk absorbs the remainder (``count % nchunks``), so uneven
    payloads never produce an empty chunk and never reorder elements —
    chunked rank-order folds stay bitwise-equal to monolithic ones.
    """

    __slots__ = ("count", "nchunks", "bounds")

    def __init__(self, count: int, nchunks: int):
        count, nchunks = int(count), int(nchunks)
        nchunks = max(1, min(nchunks, count))
        base = count // nchunks
        self.count = count
        self.nchunks = nchunks
        self.bounds = [(i * base, (i + 1) * base if i < nchunks - 1 else count)
                       for i in range(nchunks)]

    @classmethod
    def maybe(cls, count: int, itemsize: int) -> Optional["ChunkSchedule"]:
        """The schedule for a payload, or None when pipelining is off or
        the payload is below ``pipeline_min_bytes`` (monolithic path)."""
        from . import config
        cfg = config.load()
        if cfg.pipeline_min_bytes <= 0 or cfg.pipeline_chunks < 2:
            return None
        if int(count) * int(itemsize) < cfg.pipeline_min_bytes:
            return None
        sched = cls(count, cfg.pipeline_chunks)
        return sched if sched.nchunks > 1 else None

    def __iter__(self):
        return iter(self.bounds)

    def __len__(self) -> int:
        return self.nchunks

    def __repr__(self) -> str:
        return f"ChunkSchedule({self.count} elems x {self.nchunks} chunks)"


class CollectivePlan:
    """Everything a repeated same-signature collective can pre-resolve:
    the resolved :class:`~tpu_mpi_torch.operators.Op`, the rendezvous combine
    closure, the opname tag, the trace-verifier signature, the algorithm
    hint for the multi-process tier (carrying the ``tune.select`` decision,
    so the algorithm is resolved once per signature and invalidated with
    the plan), and the chunk schedule."""

    __slots__ = ("opname", "op", "combine", "sig", "hint", "schedule",
                 "generation", "algo")

    def __init__(self, opname: str, op: Any, combine: Callable, sig: dict,
                 hint: Any, schedule: Optional[ChunkSchedule],
                 generation: int, algo: str = "star"):
        self.opname = opname
        self.op = op
        self.combine = combine
        self.sig = sig
        self.hint = hint
        self.schedule = schedule
        self.generation = generation
        self.algo = algo


class AutoArmEntry:
    """Auto-arm state of ONE repeated collective signature: the
    consecutive-identical-call streak, the buffer
    identities it was counted against, and — once the streak crosses
    ``config.auto_arm_threshold`` — the bound :class:`PlanRegistration`
    whose ``run_round`` the plain call is promoted onto. Owned by
    :class:`PlanCache`; demotion drops the registration (releasing its
    pinned scratch and any shm slot lease) but keeps counting, so the
    signature re-arms after another full streak."""

    __slots__ = ("key", "streak", "calls", "send", "recv", "reg", "hits",
                 "demotions", "rounds", "results", "ineligible_gen")

    def __init__(self, key: Any):
        self.key = key
        self.streak = 0         # consecutive calls with identical buffers
        self.calls = 0          # every call noted against this signature
        self.send = _NO_BUF     # buffer identities of the current streak
        self.recv = _NO_BUF
        self.reg = None         # live PlanRegistration once armed
        self.hits = 0           # rounds run on the armed fast path
        self.demotions = 0
        self.rounds = 0         # armed-round ordinal (R302 trace model)
        self.results = deque(maxlen=4)   # recent result refs (id keep-alive)
        self.ineligible_gen = None  # registration factory said no (per gen)

    @property
    def armed(self) -> bool:
        return self.reg is not None


_NO_BUF = object()   # "no buffer seen yet" sentinel (None is a real value)


class PlanCache:
    """Bounded LRU of :class:`CollectivePlan` keyed on the collective's
    full call signature: (cid, family, op identity, count, dtype, array
    kind, flavor). Entries from a stale ``config.GENERATION`` miss (the
    pipeline knobs feed the schedule), and :meth:`invalidate` drops a
    freed communicator's plans. Unhashable keys (an unhashable custom op)
    simply never cache. Both tables are LRU-bounded by the
    ``TPU_MPI_PLAN_CACHE_MAX`` pressure guard (variable batch shapes mint
    a new signature per ``(count, dtype)``); evictions are counted and
    reported in the pvar plan-cache block.

    Also owns the **auto-arm table**: per-signature
    :class:`AutoArmEntry` records counting repeated identical plain
    collective calls toward transparent promotion onto the registered
    persistent path, plus the aggregate armed/demoted/hit counters that
    ``stats()`` (and ``tpurun --stats`` / the serve broker) report."""

    CAP = 128            # built-in default; TPU_MPI_PLAN_CACHE_MAX overrides
    AUTO_CAP = 32

    def __init__(self):
        self._lock = locksmith.make_lock("overlap.plancache")
        self._plans: "OrderedDict[Any, CollectivePlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0              # plans dropped by LRU cap pressure
        self._auto: "OrderedDict[Any, AutoArmEntry]" = OrderedDict()
        self._auto_last: dict = {}      # (cid, rank) -> last signature seen
        self._auto_hot: dict = {}       # (cid, rank) -> front-door record
        self.auto_arms = 0
        self.auto_demotions = 0
        self.auto_hits = 0
        self.auto_evictions = 0         # auto-arm entries dropped by the cap
        self._cap_gen = None            # config.GENERATION the caps reflect
        self._cap = self.CAP
        self._auto_cap = self.AUTO_CAP
        self._reserved = 0              # bucket-aware floor (reserve())
        # prime the knob read now: the first-ever config.load() bumps
        # GENERATION, which must not happen inside a later put() (it would
        # invalidate the very plan being stored)
        with self._lock:
            self._caps()

    def _caps(self) -> tuple:
        """(plan cap, auto-table cap), re-read from config per generation —
        the TPU_MPI_PLAN_CACHE_MAX pressure guard for shape churn. Caller
        holds the lock."""
        from . import config
        if self._cap_gen != config.GENERATION:
            cap = max(8, int(config.load().plan_cache_max))
            self._cap_gen = config.GENERATION
            self._cap = cap
            self._auto_cap = max(8, cap // 4)
        return self._cap, self._auto_cap

    def get(self, key: Any) -> Optional[CollectivePlan]:
        from . import config
        try:
            hash(key)
        except TypeError:
            return None
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None and plan.generation == config.GENERATION:
                self._plans.move_to_end(key)
                self.hits += 1
                return plan
            if plan is not None:                 # stale config generation
                del self._plans[key]
            self.misses += 1
            return None

    def put(self, key: Any, plan: CollectivePlan) -> None:
        try:
            hash(key)
        except TypeError:
            return
        with self._lock:
            cap, _ = self._caps()
            cap = max(cap, self._reserved)
            self._plans[key] = plan
            self._plans.move_to_end(key)
            while len(self._plans) > cap:
                self._plans.popitem(last=False)
                self.evictions += 1

    def reserve(self, n: int) -> int:
        """Bucket-aware arm hint: raise the effective LRU
        capacity floor to at least ``n`` plans so a set of persistent
        gradient-bucket plans armed together can never evict itself (or
        be evicted by concurrent shape churn) mid-step. Monotonic — the
        floor only grows; the configured cap still applies when larger.
        Returns the effective floor."""
        with self._lock:
            self._reserved = max(self._reserved, int(n))
            return self._reserved

    # -- auto-arm table ------------------------------------------

    def auto_note(self, key: Any, send: Any, recv: Any) -> \
            Optional[AutoArmEntry]:
        """Advance the identity streak of one signature and return its
        entry. A call with DIFFERENT buffer objects than the previous one
        resets the streak (and demotes a live registration — fresh-array
        loops never arm, object churn demotes loud-free); ``None`` when the
        key is unhashable."""
        try:
            hash(key)
        except TypeError:
            return None
        with self._lock:
            # shape/dtype churn on the same (cid, rank) lane demotes the
            # previously-armed signature: a loop whose operand geometry
            # changed is no longer the loop that armed, and its pinned
            # scratch must not linger
            lane = (key[0], key[1]) if isinstance(key, tuple) \
                and len(key) >= 2 else key
            prev = self._auto_last.get(lane)
            if prev is not None and prev != key:
                pe = self._auto.get(prev)
                if pe is not None:
                    self._auto_demote_locked(pe)
                    pe.streak = 0
            self._auto_last[lane] = key
            e = self._auto.get(key)
            if e is None:
                _, auto_cap = self._caps()
                e = self._auto[key] = AutoArmEntry(key)
                while len(self._auto) > auto_cap:
                    _, old = self._auto.popitem(last=False)
                    self._auto_demote_locked(old)
                    self.auto_evictions += 1
            else:
                self._auto.move_to_end(key)
            if e.send is not send or e.recv is not recv:
                self._auto_demote_locked(e)
                e.streak = 0
                e.send, e.recv = send, recv
                e.ineligible_gen = None
            e.streak += 1
            e.calls += 1
            return e

    def auto_hot_get(self, lane: Any):
        """Front-door record of one (cid, rank) lane, or None. Lock-free:
        a single dict probe under the GIL — the caller re-validates the
        registration (released/generation) before trusting it, so a racing
        demotion at worst costs one fall-through to the full gate."""
        return self._auto_hot.get(lane)

    def auto_hot_set(self, lane: Any, rec: tuple) -> None:
        """Publish the armed front-door record for a lane (the exact
        argument tuple of the call that just ran armed, its entry, and the
        send operand's byte size as an in-place-resize tripwire)."""
        self._auto_hot[lane] = rec

    def auto_bind(self, e: AutoArmEntry, reg: Any) -> None:
        """Attach a freshly-built registration to an entry (arm event)."""
        with self._lock:
            if e.reg is not None:
                self._auto_demote_locked(e)
            e.reg = reg
            e.rounds = 0
            self.auto_arms += 1

    def auto_hit(self, e: AutoArmEntry) -> None:
        with self._lock:
            e.hits += 1
            self.auto_hits += 1

    def auto_demote(self, e: AutoArmEntry) -> None:
        """Drop an entry's registration (trace arming, nonblocking traffic,
        identity churn, config reload, LRU pressure). Counting continues —
        the signature re-arms after another full streak."""
        with self._lock:
            self._auto_demote_locked(e)

    def _auto_demote_locked(self, e: AutoArmEntry) -> None:
        reg, e.reg = e.reg, None
        if reg is None:
            return
        # the front-door record holds strong refs to the armed call's
        # buffers; drop it with the registration so demotion releases them
        if isinstance(e.key, tuple) and len(e.key) >= 2:
            self._auto_hot.pop((e.key[0], e.key[1]), None)
        e.demotions += 1
        self.auto_demotions += 1
        try:
            registry.discard(reg)
        except Exception:
            pass

    def invalidate(self, cid: Any = None) -> None:
        """Drop every plan (no args) or one communicator's plans
        (``Comm.free``). Auto-arm entries of the communicator are demoted
        and dropped too (their registrations release pinned scratch and
        shm slot leases)."""
        with self._lock:
            if cid is None:
                self._plans.clear()
                for e in self._auto.values():
                    self._auto_demote_locked(e)
                self._auto.clear()
                self._auto_last.clear()
                self._auto_hot.clear()
                return
            for k in [k for k in self._plans if k[0] == cid]:
                del self._plans[k]
            for k in [k for k in self._auto if k[0] == cid]:
                self._auto_demote_locked(self._auto.pop(k))
            for lane in [ln for ln in self._auto_last
                         if isinstance(ln, tuple) and ln[0] == cid]:
                del self._auto_last[lane]
            for lane in [ln for ln in self._auto_hot if ln[0] == cid]:
                del self._auto_hot[lane]

    def stats(self) -> dict:
        with self._lock:
            sigs = {}
            for k, e in self._auto.items():
                label = "/".join(str(p) for p in k)
                sigs[label] = {
                    "calls": e.calls, "streak": e.streak,
                    "armed": e.reg is not None, "hits": e.hits,
                    "demotions": e.demotions,
                    "hit_rate": (e.hits / e.calls) if e.calls else 0.0,
                }
            cap, auto_cap = self._caps()
            return {"entries": len(self._plans), "hits": self.hits,
                    "misses": self.misses,
                    "cap": max(cap, self._reserved),
                    "reserved": self._reserved,
                    "evictions": self.evictions,
                    "auto": {"tracked": len(self._auto),
                             "armed": sum(1 for e in self._auto.values()
                                          if e.reg is not None),
                             "arms": self.auto_arms,
                             "demotions": self.auto_demotions,
                             "hits": self.auto_hits,
                             "cap": auto_cap,
                             "evictions": self.auto_evictions,
                             "signatures": sigs}}


#: The process-wide plan cache. ``Comm.free`` invalidates per-cid; config
#: reloads invalidate by generation.
plans = PlanCache()


def hint_buckets(comm, nbuckets: int) -> int:
    """Bucket-aware arm hint from the training tier (docs/training.md):
    before arming a gradient-bucket set on ``comm``, guarantee the plan
    cache holds the whole set — one plan per bucket, doubled for the
    send/recv signature pair a control lane may also arm, plus headroom
    for unrelated concurrent traffic. Returns the effective floor."""
    return plans.reserve(2 * int(nbuckets) + 8)


class ChunkProgress:
    """In-flight chunk state for one nonblocking collective, advanced by
    whichever progress thread moves the op (the per-comm worker; at a
    multi-process star root, the fold loop fed by the drainer) and read by
    ``Test``/``Wait`` and by benchmarks. ``total`` is 0 until the op's
    chunk schedule is known (monolithic ops never set it)."""

    __slots__ = ("done", "total", "stage")

    def __init__(self):
        self.done = 0
        self.total = 0
        self.stage = "pending"

    def begin(self, total: int, stage: str) -> None:
        self.total = int(total)
        self.done = 0
        self.stage = stage

    def note(self, done: Optional[int] = None) -> None:
        self.done = self.done + 1 if done is None else int(done)

    def __repr__(self) -> str:
        return f"<ChunkProgress {self.stage} {self.done}/{self.total}>"


_progress_tls = threading.local()


def bind_progress(prog: Optional[ChunkProgress]) -> None:
    """Bind the progress record the current thread's collective work should
    advance (set by the nonblocking worker around each op; None clears)."""
    _progress_tls.current = prog


def current_progress() -> Optional[ChunkProgress]:
    return getattr(_progress_tls, "current", None)


def progress_begin(total: int, stage: str) -> Optional[ChunkProgress]:
    prog = current_progress()
    if prog is not None:
        prog.begin(total, stage)
    return prog


def progress_note(prog: Optional[ChunkProgress]) -> None:
    if prog is not None:
        prog.note()


class PlanRegistration:
    """Plan-bound registered buffers + the pre-resolved round closure of one
    persistent collective. Built once at
    ``Allreduce_init`` by :func:`tpu_mpi_torch.collective._register_allreduce`:
    arguments parsed, wire views pinned, the fold scratch pre-allocated
    (``buffers.register_scratch``), the combine / copy-out pre-bound — a
    Start/Wait round is then one inline rendezvous with zero allocation,
    no plan lookup and no worker hop. Tracked in :data:`registry` so
    ``Comm.free`` releases the pinned buffers and any shm slot lease."""

    __slots__ = ("cid", "world", "generation", "scratch", "wire", "run_round",
                 "shm_release", "released", "knob_on", "_nb_probe",
                 "inplace_optin", "round_parts")

    def __init__(self, cid: int, generation: int, run_round: Callable[[], Any],
                 scratch: tuple = (), wire: Any = None,
                 shm_release: Optional[Callable[[], None]] = None,
                 knob_on: bool = True, nb_probe: Optional[Callable] = None,
                 inplace_optin: bool = False, round_parts: Any = None):
        self.cid = cid
        self.world = _world()           # the run whose rank armed the plan
        self.generation = generation
        self.run_round = run_round
        self.scratch = scratch          # pinned fold accumulators (id-stable)
        self.wire = wire                # pre-bound send wire view, if host
        self.shm_release = shm_release
        self.released = False
        self.knob_on = knob_on
        self._nb_probe = nb_probe       # () -> outstanding nb ops on the comm
        self.inplace_optin = inplace_optin
        # batched-submission hook: the round's split pieces
        # (channel, rank, contrib, combine, opname, runkw, copyout, …) so a
        # Waitall over several armed rounds can deposit them all through ONE
        # thread-tier rendezvous (CollectiveChannel.run_batch). None on the
        # multi-process tier and for registrations that predate the split.
        self.round_parts = round_parts

    def armable(self) -> bool:
        """Whether a Start may take the fast path right now: the knob is on,
        the run is untraced (traced runs keep the fully-evented legacy
        path), and this comm's nonblocking worker is idle (in-flight ``I*``
        ops own the initiation order)."""
        if self.released or not self.knob_on:
            return False
        from .analyze import events as _ev
        if _ev.enabled():
            return False
        return self._nb_probe is None or self._nb_probe() == 0

    def release(self) -> None:
        """Drop the pinned buffers and any shm slot lease (``Comm.free``)."""
        if self.released:
            return
        self.released = True
        self.scratch = ()
        self.wire = None
        self.round_parts = None
        rel, self.shm_release = self.shm_release, None
        if rel is not None:
            rel()


def _next_plan_id(comm: Any) -> Optional[int]:
    """The plan id of a new persistent request: how many this rank made on
    ``comm`` before it. Persistent initialization is collective and
    ordered, so request k of one rank is request k of every rank."""
    from ._runtime import current_env
    env = current_env()
    if env is None or comm is None or not hasattr(env[0], "objects"):
        return None
    ctx, world_rank = env
    key = ("pplan", comm.cid, world_rank)
    with ctx.objects_lock:
        n = ctx.objects.get(key, 0)
        ctx.objects[key] = n + 1
    return n


def _world() -> Any:
    """The run (its ``SpmdContext``) of the calling rank thread, or None."""
    from ._runtime import current_env
    env = current_env()
    return None if env is None else env[0]


class BufferRegistry:
    """Process-wide registry of live :class:`PlanRegistration` instances,
    keyed by (run, communicator cid): every run's ``COMM_WORLD`` has cid 0,
    so the cid alone would mix the runs. ``Comm.free`` calls
    :meth:`release` so plan-registered wire buffers and shm segment slots
    never outlive their communicator, and ``spmd_run`` calls
    :meth:`release_world` when its run ends, for the communicators (its
    ``COMM_WORLD`` among them) that were never freed; ``TPU_MPI_STRICT``
    asserts the lease count actually hit zero."""

    def __init__(self):
        self._lock = locksmith.make_lock("overlap.registrations")
        self._by_key: dict[tuple, list] = {}

    def add(self, reg: PlanRegistration) -> PlanRegistration:
        with self._lock:
            self._by_key.setdefault((reg.world, reg.cid), []).append(reg)
        return reg

    def _release(self, match: Callable[[tuple], bool]) -> int:
        with self._lock:
            keys = [k for k in self._by_key if match(k)]
            regs = [reg for k in keys for reg in self._by_key.pop(k)]
        for reg in regs:
            reg.release()
        return len(regs)

    def release(self, cid: Any) -> int:
        """Release every registration of one communicator of the calling
        rank's run; returns how many were released."""
        key = (_world(), cid)
        return self._release(lambda k: k == key)

    def release_world(self, world: Any) -> int:
        """Release every registration of one run (a finished
        ``spmd_run``'s context); returns how many were released."""
        return self._release(lambda k: k[0] is world)

    def discard(self, reg: PlanRegistration) -> None:
        """Release ONE registration and drop it from the ledger (auto-arm
        demotion — the comm stays alive, only this plan's pinned buffers
        and shm lease go)."""
        key = (reg.world, reg.cid)
        with self._lock:
            lst = self._by_key.get(key)
            if lst is not None and reg in lst:
                lst.remove(reg)
                if not lst:
                    del self._by_key[key]
        reg.release()

    def leased(self, cid: Any = None) -> int:
        """Outstanding shm slot leases (one comm of the calling rank's run,
        or all) — the strict-mode refcount the ``Comm.free`` assert reads."""
        key = (_world(), cid)
        with self._lock:
            regs = [r for k, rs in self._by_key.items()
                    if cid is None or k == key for r in rs]
        return sum(1 for r in regs if r.shm_release is not None
                   and not r.released)

    def stats(self) -> dict:
        with self._lock:
            return {"comms": len(self._by_key),
                    "registrations": sum(len(v) for v in self._by_key.values())}


#: Live plan registrations; ``Comm.free`` releases per communicator,
#: ``spmd_run`` per run.
registry = BufferRegistry()


_fast_tls = threading.local()     # .armed: {cid: [PersistentCollRequest]}


def _armed_list(cid: Any) -> list:
    armed = getattr(_fast_tls, "armed", None)
    if armed is None:
        armed = _fast_tls.armed = {}
    lst = armed.get(cid)
    if lst is None:
        lst = armed[cid] = []
    return lst


def demote_fast_armed(cid: Any = None) -> None:
    """Push every fast-armed persistent request on THIS thread (of one comm,
    or of all comms) onto the legacy worker path, in Start order. Called
    before anything else initiates on the same communicator — a blocking
    collective (``collective._ordered_run``), a nonblocking submit
    (``collective._nb_submit``), or a second Start — so initiation order
    stays the program order even though fast-armed rounds defer their
    rendezvous to ``Wait``."""
    armed = getattr(_fast_tls, "armed", None)
    if not armed:
        return
    cids = [cid] if cid is not None else list(armed)
    for c in cids:
        lst = armed.get(c)
        if not lst:
            continue
        # detach the whole stack before initiating any of it: each legacy
        # submission first demotes this comm's armed rounds itself
        # (collective._nb_submit), so demoting one request at a time would
        # submit the later rounds from inside the earlier one's submission,
        # in reverse Start order, and a rank whose Starts went legacy would
        # pair its rounds with other buckets
        reqs = list(lst)
        lst.clear()
        for req in reqs:
            req._fast_armed = False
        for req in reqs:
            req._inner = req._make()


def flush_fast_armed(cid: Any, upto: Any = None) -> None:
    """Complete fast-armed rounds of one comm on THIS thread, in Start
    order, stopping after ``upto`` (a :class:`PersistentCollRequest`) or
    draining the whole stack. Runs of 2+ rounds whose registrations carry
    ``round_parts`` go through batched rendezvous submission
    (``CollectiveChannel.run_batch``) — K rounds deposit through ONE
    channel lock acquisition and ONE wakeup —
    chunked by ``config.batch_max_ops`` / ``config.batch_max_bytes``.
    Each completed request gets its ``result``/``status`` set exactly as
    an inline fast-armed ``wait`` would."""
    lst = _armed_list(cid)
    if not lst:
        return
    run = []
    for r in lst:
        run.append(r)
        if upto is not None and r is upto:
            break
    from . import config
    cfg = config.load()
    cap = max(int(cfg.batch_max_ops), 1)
    max_bytes = int(cfg.batch_max_bytes)
    i = 0
    while i < len(run):
        group = [run[i]]
        nbytes = int((run[i]._reg.round_parts or {}).get("pv_nbytes") or 0) \
            if run[i]._reg is not None and run[i]._reg.round_parts else 0
        i += 1
        while i < len(run) and len(group) < cap:
            reg = run[i]._reg
            if reg is None or reg.round_parts is None \
                    or (group[0]._reg is None
                        or group[0]._reg.round_parts is None):
                break
            b = int(reg.round_parts.get("pv_nbytes") or 0)
            if max_bytes > 0 and nbytes + b > max_bytes:
                break
            group.append(run[i])
            nbytes += b
            i += 1
        _flush_group(cid, group)


def _flush_group(cid: Any, group: list) -> None:
    from .pointtopoint import STATUS_EMPTY
    lst = _armed_list(cid)
    for r in group:
        r._fast_armed = False
        if r in lst:
            lst.remove(r)
    if len(group) == 1 or any(r._reg is None or r._reg.round_parts is None
                              for r in group):
        # no batch lane: inline rounds in Start order (the pre-batching
        # fast-armed wait), each its own rendezvous
        from ._runtime import persistent_round
        for r in group:
            with persistent_round(r.round_key):
                r.result = r._reg.run_round()
            r.status = STATUS_EMPTY
            r._trace_complete()
        return
    from . import perfvars as _pv
    parts = [r._reg.round_parts for r in group]
    channel = parts[0]["channel"]
    rank = parts[0]["rank"]
    ops = [(p["contrib"](), p["combine"], p["opname"],
            bool(p["runkw"].get("unlocked_fold")), (r.round_key, p["stamp"]))
           for r, p in zip(group, parts)]
    sc = _pv.op_begin() if _pv.enabled() else None
    try:
        results = channel.run_batch(rank, ops)
        for r, p, res in zip(group, parts, results):
            if sc is None:
                r.result = p["copyout"](res)
            else:
                t0 = sc.start()
                r.result = p["copyout"](res)
                sc.phase("copy", t0)
            r.status = STATUS_EMPTY
            r._trace_complete()
    finally:
        _pv.note_batch(cid, len(group))
        if sc is not None:
            p0 = parts[0]
            sig = p0["sig"]
            _pv.op_end(sc, p0["comm"], coll="allreduce",
                       algo=sig.get("algo"), dtype=sig.get("dtype"),
                       nbytes=sum(int(p.get("pv_nbytes") or 0)
                                  for p in parts))


def waitall_flush(reqs) -> None:
    """Batch-complete every fast-armed persistent round in ``reqs``
    (``Waitall``'s hook): per comm, flush the armed stack in
    Start order up to the DEEPEST member of ``reqs``, so the whole run
    submits through one rendezvous wakeup regardless of the order the
    caller listed the requests in."""
    by_cid: dict = {}
    for r in reqs:
        if isinstance(r, PersistentCollRequest) and r._fast_armed \
                and r._reg is not None:
            by_cid.setdefault(r._reg.cid, set()).add(id(r))
    for cid, ids in by_cid.items():
        deepest = None
        for r in _armed_list(cid):
            if id(r) in ids:
                deepest = r
        if deepest is not None:
            flush_fast_armed(cid, upto=deepest)


class PersistentCollRequest:
    """Persistent collective request (MPI-4 ``MPI_Allreduce_init`` family),
    mirroring :class:`tpu_mpi_torch.pointtopoint.Prequest`: created INACTIVE with
    the operation's arguments bound (and its plan pre-resolved), armed by
    ``Start``/``Startall``, completed by the whole Wait/Test family, then
    inactive-but-reusable for the next round.

    Two execution lanes. The **registered fast path** (a
    :class:`PlanRegistration` bound via :meth:`bind_registration`, the
    default when the operands are eligible): Start arms the round and Wait
    runs it INLINE on the calling thread against the pre-pinned buffers —
    one rendezvous round trip, zero allocation. The **legacy lane**: each
    Start initiates the collective on this rank's per-comm worker, so
    rounds progress in the background exactly like the one-shot ``I*``
    ops; Test on a fast-armed round demotes to this lane (Test must not
    block)."""

    def __init__(self, make: Callable[[], Any], kind: str, buffer: Any,
                 comm: Any = None):
        self._make = make           # () -> a live CollRequest
        self._inner = None
        self.kind = kind            # e.g. "pallreduce"
        self.buffer = buffer
        self.status = None
        self.result = None          # allocating flavors: last round's value
        self._reg: Optional[PlanRegistration] = None
        self._reg_factory: Optional[Callable[[], Any]] = None
        self._fast_armed = False
        # tracing state (tpu_mpi_torch.analyze): the comm the Start/Wait events
        # record against, rounds started so far, and strong refs to recent
        # round results so R302's invalidation ids stay unrecycled.
        self._comm = comm
        self._round = 0
        self._plan_id = _next_plan_id(comm)
        self._results: deque = deque(maxlen=4)

    def bind_registration(self, factory: Callable[[], Any]
                          ) -> "PersistentCollRequest":
        """Attach the registered-buffer fast path: ``factory()`` builds a
        :class:`PlanRegistration` (or None when the operands are not
        eligible) and is re-run to rebind buffers after a config-generation
        change."""
        self._reg_factory = factory
        self._reg = factory()
        return self

    @property
    def round_key(self) -> tuple:
        """The cross-rank key of the round last Started: (plan id, round),
        checked by the thread tier's rendezvous (``_runtime.round_stamp``)."""
        return (self._plan_id, self._round - 1)

    @property
    def registration(self) -> Optional[PlanRegistration]:
        """The live registration (None = generic path). Exposed for tests
        and benchmarks asserting id-stable pinned buffers."""
        return self._reg

    def start(self) -> "PersistentCollRequest":
        if self.active:
            raise MPIError("Start on an already-active persistent request",
                           code=_ec.ERR_REQUEST)
        from .analyze import events as _ev
        if _ev.enabled() and self._comm is not None:
            # R302 front end: on the donated fast path, this Start re-donates
            # the 2-slot fold ring entry holding round (k-2)'s result — name
            # that buffer so the race pass can flag reads-after-invalidation.
            inval = None
            for rnd, res in self._results:
                if rnd == self._round - 2:
                    inval = _ev.buf_id(res)
            _ev.record_start(self._comm, self.kind, id(self), self._round,
                             invalidates=inval)
        self._round += 1
        reg = self._reg
        if reg is not None:
            from . import config
            if reg.generation != config.GENERATION \
                    and self._reg_factory is not None:
                # config reload: rebind the registered buffers (the pipeline
                # knobs feed the schedule; the knob itself may have flipped)
                reg = self._reg = self._reg_factory()
        if reg is not None and reg.armable():
            lst = _armed_list(reg.cid)
            if lst:
                # earlier armed rounds on this comm. When every round —
                # theirs and ours — carries the batched-submission parts
                # (thread tier) and the stack is under the batch cap, STACK
                # instead of demoting: Wait/Waitall completes the stack in
                # Start order through one rendezvous wakeup
                # (flush_fast_armed -> CollectiveChannel.run_batch,
                #). Otherwise demote the earlier armed rounds to
                # the worker (initiation order = Start order); the worker
                # is then busy, so this round goes legacy too.
                from . import config
                cap = int(config.load().batch_max_ops)
                stackable = (cap > 1 and len(lst) < cap
                             and reg.round_parts is not None
                             and all(r._reg is not None
                                     and r._reg.round_parts is not None
                                     for r in lst))
                if not stackable:
                    demote_fast_armed(reg.cid)
            if reg.armable():
                self._fast_armed = True
                _armed_list(reg.cid).append(self)
                return self
        self._inner = self._make()
        return self

    @property
    def active(self) -> bool:
        return self._fast_armed or \
            (self._inner is not None and self._inner.active)

    @property
    def progress(self) -> Optional[ChunkProgress]:
        return getattr(self._inner, "progress", None)

    def test(self) -> bool:
        if self._fast_armed:
            # Test must not block: hand the round to the worker and poll
            # it. Demote the comm's WHOLE armed stack — initiation order
            # is Start order, so earlier stacked rounds must reach the
            # worker before (and later ones may not stay deferred behind)
            # this one.
            demote_fast_armed(self._reg.cid)
        if self._inner is None:
            return True
        done = self._inner.test()
        if done:
            self.result = self._inner.result
        return done

    def wait(self):
        from .pointtopoint import STATUS_EMPTY
        if self._fast_armed:
            # completes every armed round up to ours in Start order —
            # batched through one rendezvous wakeup when stacked
            flush_fast_armed(self._reg.cid, upto=self)
            return self.status
        if self._inner is None:
            return self.status or STATUS_EMPTY
        # Wait-time ownership (the outermost-owner rule):
        # the round's wall clock is already fully accounted by the op scope
        # its worker owns (its phases + times), so the inner CollRequest.wait
        # must not ALSO bump wait_ns for the same interval.
        from . import perfvars as _pv
        claimed = _pv.own_wait()
        try:
            self.status = self._inner.wait()
        finally:
            if claimed:
                _pv.disown_wait()
        self.result = self._inner.result
        self._inner = None          # inactive, ready for the next Start
        self._trace_complete()
        return self.status

    def _consume(self):
        from .pointtopoint import STATUS_EMPTY
        if self._fast_armed:
            return self.wait()
        if self._inner is None:
            return self.status or STATUS_EMPTY
        from . import perfvars as _pv
        claimed = _pv.own_wait()
        try:
            self.status = self._inner.wait() if self._inner.active \
                else (self._inner.status or STATUS_EMPTY)
        finally:
            if claimed:
                _pv.disown_wait()
        self.result = self._inner.result
        self._inner = None
        self._trace_complete()
        return self.status

    def _trace_complete(self) -> None:
        """Record the Wait that completed round ``self._round - 1`` and pin
        its result object (identity anchor for R302's invalidation window)."""
        from .analyze import events as _ev
        if not _ev.enabled() or self._comm is None:
            return
        rnd = self._round - 1
        self._results.append((rnd, self.result))
        _ev.record_wait(self._comm, self.kind, id(self), rnd,
                        result=self.result)

    def cancel(self) -> None:
        raise MPIError("nonblocking collectives cannot be cancelled")

    def __repr__(self) -> str:
        return f"<PersistentCollRequest {self.kind} active={self.active}>"
