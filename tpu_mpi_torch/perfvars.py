"""MPI_T-inspired performance variables (pvars): always-on counters + spans.

The reference ships no tracing at all (SURVEY.md: only ``Wtime``/``Wtick``;
external PMPI/MPI_T tools are assumed) — this module is the layer those
tools would have provided, owned by the runtime itself. Three cooperating
pieces:

- **Per-comm counters** keyed ``(world rank, cid)``: bytes sent/received,
  op counts per ``(collective, algorithm, dtype)``, time blocked in the
  Wait family, host-path phase time split rendezvous / fold / copy,
  chunk-pipeline overlap inputs, RMA epoch counts, and per-collective
  latency histograms (log2-µs buckets, ``config.pvars_hist_bins`` wide).
  Plan-cache hits/misses ride along at snapshot time from
  ``overlap.plans.stats()``.
- **Timed spans** on the event IR: when tracing is on, the op scope opened
  here stamps the recorded :class:`~tpu_mpi_torch.analyze.events.Event` with
  ``t_start``/``t_end`` and the phase spans the channels observed, which
  :mod:`tpu_mpi_torch.analyze.timeline` renders as a Chrome-trace / Perfetto
  timeline.
- **Runtime control**: the MPI-standard ``Pcontrol(level)``
  (:func:`tpu_mpi_torch.environment.Pcontrol` delegates here) — 0 disables, 1
  enables (the default), >= 2 enables AND flushes a dump immediately.

Overhead discipline (the ``analyze.events.enabled()`` contract): every hot
hook front-loads :func:`enabled` — one tuple compare against
``config.GENERATION`` — so a ``TPU_MPI_PVARS=0`` run pays a single
predictable branch per operation; the committed
``benchmarks/results/overhead-pvars-cpusim.json`` artifact pins that.

Span-attribution caveat: phase spans collect into a thread-local op scope,
so a BLOCKING collective that routes through the nonblocking worker (only
when that comm has outstanding ``I*`` ops) keeps its counters but loses its
per-phase spans — the worker thread owns no scope for it.

One clock: every span and phase counter here is taken on
``time.perf_counter_ns``, the clock of ``MPI.Wtime``; :data:`monotonic` is
its float-seconds view. The **span ring** (:func:`spans_on` /
:func:`spans_off`; off by default) keeps the op scopes' phase spans and
the spans the trainers and the model step open with :func:`span_begin` /
:func:`span_end`, each with the thread's CPU time over it, in one bounded
ring per thread, drained by :func:`take_spans`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import config
from . import tracectx as _tc
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

# float seconds on the clock of every span and phase (perf_counter_ns)
monotonic = time.perf_counter

# the per-comm phases (``phase_s``: the JAX package's schema, which stats
# reports render)
PHASES = ("rendezvous", "fold", "copy",
          # hierarchical-composite sub-phases (backend._run_hier_*)
          "intra_fold", "inter_exchange", "allgather")
# with ``enter`` (the op's start to this rank's deposit in a channel): the
# phases of the per-collective split that frontdoor_totals reads
OP_PHASES = ("enter",) + PHASES

_UNSET = object()
_enabled_cache: Tuple[Any, bool] = (_UNSET, False)
# Pcontrol's runtime override: None = follow config.pvars.
_level_override: Optional[int] = None
_store_lock = threading.Lock()
_store: Dict[Tuple[int, int], "CommPvars"] = {}
# bumped whenever accumulators are dropped from _store, so the per-thread
# _acct caches never keep writing into an orphaned accumulator
_store_gen = 0


class _TLS(threading.local):
    # class-attribute defaults: fresh threads read these without the
    # AttributeError/getattr-default dance on the hot path
    scope = None                      # the open _OpScope of this thread
    acct = None                       # (store_gen, {key: CommPvars}) cache
    wait_owned = False                # a wait-time owner is on the stack
    ring = None                       # this thread's _Ring
    depth = 0                         # open ring spans on this thread


_tls = _TLS()


def _config_level() -> int:
    if _level_override is not None:
        config.load()               # keep GENERATION meaningful for the gate
        return _level_override
    return int(config.load().pvars)


def enabled() -> bool:
    """Whether pvar collection is on — cached on ``config.GENERATION`` so
    the per-operation cost of a disabled run is one tuple compare."""
    global _enabled_cache
    cached_gen, val = _enabled_cache
    if cached_gen == config.GENERATION:
        return val
    val = _config_level() >= 1
    _enabled_cache = (config.GENERATION, val)
    return val


def level() -> int:
    """The effective collection level (0 off, 1 on; >= 2 behaves as 1 —
    the flush side effect belongs to :func:`pcontrol` itself)."""
    return _config_level()


def pcontrol(lvl: int) -> int:
    """Runtime toggle (the ``MPI_Pcontrol`` contract): 0 disables
    collection, 1 restores the default (the ``pvars`` config knob), and
    any level >= 2 enables collection and immediately flushes a dump to
    ``config.pvars_dump`` (when set). Returns the effective level."""
    global _level_override, _enabled_cache
    lvl = int(lvl)
    if lvl < 0:
        lvl = 0
    _level_override = None if lvl == 1 else lvl
    _enabled_cache = (config.GENERATION, _config_level() >= 1)
    if lvl >= 2:
        finalize_dump(force=True)
    return _config_level()


class CommPvars:
    """The counter set of one ``(world rank, cid)`` pair."""

    __slots__ = ("rank", "cid", "size", "bytes_sent", "bytes_recv", "sends",
                 "recvs", "wait_ns", "ops", "times", "rma",
                 "hist", "pipe_ops", "pipe_chunks", "pipe_fold_ns",
                 "pipe_wait_ns", "explore_calls", "explore_explored",
                 "table_swaps", "last_swap_gen", "batch_flushes",
                 "batch_ops", "coll_phase_ns")

    def __init__(self, rank: int, cid: int):
        self.rank = rank
        self.cid = cid
        self.size = 0
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.sends = 0
        self.recvs = 0
        self.wait_ns = 0
        # (coll, algo, dtype) -> op count
        self.ops: Dict[Tuple[str, str, str], int] = {}
        # (coll, algo, nbytes) -> [count, total_ns, min_ns, max_ns]
        self.times: Dict[Tuple[str, str, int], List[int]] = {}
        # coll -> {phase: ns} over OP_PHASES (frontdoor_totals; phase_s
        # is its sum over collectives)
        self.coll_phase_ns: Dict[str, Dict[str, int]] = {}
        self.rma = {"fence": 0, "lock": 0, "flush": 0}
        self.hist: Dict[str, List[int]] = {}      # coll -> log2-µs buckets
        # chunk-pipeline overlap inputs (see snapshot() for the derived
        # fraction): fold time + post-first-chunk rendezvous waits of
        # pipelined star roots
        self.pipe_ops = 0
        self.pipe_chunks = 0
        self.pipe_fold_ns = 0
        self.pipe_wait_ns = 0
        # online bandit autotuner (tpu_mpi_torch.tune_online): decisions seen,
        # decisions routed to an alternate arm, hot-swaps performed on this
        # comm, and the config generation of the last swap.
        self.explore_calls = 0
        self.explore_explored = 0
        self.table_swaps = 0
        self.last_swap_gen = 0
        # batched rendezvous submission: flushes and the ops
        # they carried — occupancy = ops / flushes
        self.batch_flushes = 0
        self.batch_ops = 0

    def snapshot(self) -> dict:
        bins = max(4, int(config.load().pvars_hist_bins))
        pipe_busy = self.pipe_fold_ns + self.pipe_wait_ns
        return {
            "rank": self.rank, "cid": self.cid, "size": self.size,
            "bytes_sent": self.bytes_sent, "bytes_recv": self.bytes_recv,
            "sends": self.sends, "recvs": self.recvs,
            "wait_s": self.wait_ns / 1e9,
            "ops": {"|".join(k): v for k, v in sorted(self.ops.items())},
            "times": [{"coll": c, "algo": a, "nbytes": b, "count": t[0],
                       "total_s": t[1] / 1e9, "min_s": t[2] / 1e9,
                       "max_s": t[3] / 1e9}
                      for (c, a, b), t in sorted(self.times.items())],
            "phase_s": {p: sum(split[p] for split in self.coll_phase_ns.values())
                        / 1e9 for p in PHASES},
            "rma": dict(self.rma),
            "hist_bins": bins,
            "hist": {c: list(h) for c, h in sorted(self.hist.items())},
            "pipeline": {
                "ops": self.pipe_ops, "chunks": self.pipe_chunks,
                "fold_s": self.pipe_fold_ns / 1e9,
                "wait_after_first_s": self.pipe_wait_ns / 1e9,
                # 1.0 = every post-first-chunk contribution had already
                # landed when the root finished the previous fold (transfer
                # fully hidden behind compute); 0.0 = fully serial
                "overlap_fraction": (round(self.pipe_fold_ns / pipe_busy, 4)
                                     if pipe_busy else None),
            },
            "explore": {
                "calls": self.explore_calls,
                "explored": self.explore_explored,
                "fraction": (round(self.explore_explored
                                   / self.explore_calls, 4)
                             if self.explore_calls else None),
                "table_swaps": self.table_swaps,
                "last_swap_gen": self.last_swap_gen,
            },
            "batch": {
                "flushes": self.batch_flushes,
                "ops": self.batch_ops,
                "occupancy": (round(self.batch_ops / self.batch_flushes, 4)
                              if self.batch_flushes else None),
            },
        }


def _acct(comm: Any = None, cid: Optional[int] = None,
          size: int = 0) -> Optional[CommPvars]:
    """The accumulator of (current world rank, comm's cid), creating it on
    first touch; None outside an SPMD environment."""
    from ._runtime import current_env
    env = current_env()
    if env is None:
        return None
    rank = env[1]
    if comm is not None:
        cid = comm.cid
    elif cid is None:
        cid = -1                      # unattributed (no comm at the hook)
    key = (rank, cid)
    cached = _tls.acct
    if cached is not None and cached[0] == _store_gen:
        acct = cached[1].get(key)
        if acct is not None:
            if comm is not None and not acct.size:
                acct.size = size or len(comm.group)
            return acct
    with _store_lock:
        acct = _store.get(key)
        if acct is None:
            acct = _store[key] = CommPvars(rank, cid)
        if comm is not None and not acct.size:
            acct.size = size or len(comm.group)
    if cached is None or cached[0] != _store_gen:
        cached = _tls.acct = (_store_gen, {})
    cached[1][key] = acct
    return acct


# ---------------------------------------------------------------------------
# Op scope: per-op span collection shared with the event IR
# ---------------------------------------------------------------------------

class _OpScope:
    """One op's phase spans, ``(name, t0, t1)`` in :data:`monotonic`
    seconds. Producers open a phase with :meth:`start` and close it with
    :meth:`phase`; with the span ring on, each phase's CPU time is kept
    beside it (``cpu``) and :func:`op_end` puts the op and its phases in
    the ring."""

    __slots__ = ("t0", "spans", "ev", "trace", "cpu", "cmark", "c0", "depth")

    def __init__(self):
        self.t0 = monotonic()
        self.spans: List[Tuple[str, float, float]] = []
        self.ev: Any = None           # the trace Event of this op, if any
        self.trace: Any = None        # the request TraceCtx, when sampled
        self.cpu: Optional[List[int]] = None   # per-phase CPU ns (ring on)
        if _spans_cap:
            self.cpu = []
            self.c0 = self.cmark = time.thread_time_ns()
            self.depth = _tls.depth
            _tls.depth += 1

    def start(self) -> float:
        """Open a phase; returns its start."""
        t = monotonic()
        if self.cpu is not None:
            self.cmark = time.thread_time_ns()
        return t

    def phase(self, name: str, t0: float) -> float:
        """Close phase ``name`` opened at ``t0``; returns its end, which
        may open the next phase."""
        if self.cpu is not None:
            c = time.thread_time_ns()
            self.cpu.append(c - self.cmark)
            self.cmark = c
        t1 = monotonic()
        self.spans.append((name, t0, t1))
        return t1

    def enter(self) -> float:
        """Close the ``enter`` phase at this rank's deposit in a channel:
        from the op's start, or from the end of its last phase; returns
        the deposit time, which opens the next phase."""
        return self.phase("enter", self.spans[-1][2] if self.spans else self.t0)


def scope() -> Optional[_OpScope]:
    """The open op scope of this thread (channels append phase spans to
    ``scope().spans``), or None."""
    return _tls.scope


def op_begin() -> Optional[_OpScope]:
    """Open an op scope on this thread. Returns None when one is already
    open — the outermost owner finalizes (``_reduce_family`` wraps ``_run``
    so the copy-out phase lands inside the same scope)."""
    if _tls.scope is not None:
        return None
    sc = _OpScope()
    if _tc.enabled():
        # request tracing: adopt the TraceCtx the serve-tier rank worker
        # bound to this thread, so the op's phase spans become children of
        # the request span (one tuple compare when sampling is off)
        sc.trace = _tc.current()
    _tls.scope = sc
    return sc


def op_end(sc: _OpScope, comm: Any = None, coll: Optional[str] = None,
           algo: Optional[str] = None, dtype: Optional[str] = None,
           nbytes: Optional[int] = None) -> None:
    """Close the scope: stamp the op's trace event (t_start/t_end/phases)
    and fold duration + spans into the per-comm counters."""
    _tls.scope = None
    shim = _shim_map()
    if shim and coll is not None:
        # test/debug latency shim (config.tune_shim): the sleep lands
        # BEFORE t1 so it is part of the measured span and is attributed
        # to this (coll, algo) arm — the knob the bandit-convergence tests
        # use to make one arm deterministically lose.
        pause = shim.get((coll, algo or "star"))
        if pause:
            time.sleep(pause)
    t1 = monotonic()
    if sc.cpu is not None:
        _ring_op(sc, coll or "op", t1)
    ev = sc.ev
    if ev is not None:
        ev.t_start = sc.t0
        ev.t_end = t1
        # the event IR and request spans carry the per-comm phases alone
        # (the JAX package's schema); enter feeds the ring and the split
        phases = [sp for sp in sc.spans if sp[0] != "enter"]
        if phases:
            ev.phases = phases
    if sc.trace is not None:
        # per-rank request span: the op bracket parents under the request
        # context, and each measured phase nests under the op span
        from ._runtime import current_env
        env = current_env()
        who = f"rank {env[1]}" if env is not None else "rank ?"
        rec = _tc.emit_span(sc.trace, coll or "op", who, sc.t0, t1,
                            algo=algo, nbytes=nbytes)
        if rec is not None:
            pctx = _tc.TraceCtx(rec["trace"], rec["span"], True)
            for name, s0, s1 in sc.spans:
                if name != "enter":
                    _tc.emit_span(pctx, name, who, s0, s1)
    if not enabled() or coll is None:
        return
    acct = _acct(comm)
    if acct is None:
        return
    bins = max(4, int(config.load().pvars_hist_bins))
    dur_ns = int((t1 - sc.t0) * 1e9)
    key = (coll, algo or "star", -1 if nbytes is None else int(nbytes))
    with _store_lock:
        # numpy's name for a tensor's dtype too (``float64``, not
        # ``torch.float64``), so the key reads as the JAX package's does
        okey = (coll, algo or "star", (dtype or "?").removeprefix("torch."))
        acct.ops[okey] = acct.ops.get(okey, 0) + 1
        t = acct.times.get(key)
        if t is None:
            acct.times[key] = [1, dur_ns, dur_ns, dur_ns]
        else:
            t[0] += 1
            t[1] += dur_ns
            if dur_ns < t[2]:
                t[2] = dur_ns
            if dur_ns > t[3]:
                t[3] = dur_ns
        split = acct.coll_phase_ns.get(coll)
        if split is None:
            split = acct.coll_phase_ns[coll] = dict.fromkeys(OP_PHASES, 0)
        for name, s0, s1 in sc.spans:
            if name in split:
                split[name] += int((s1 - s0) * 1e9)
        hist = acct.hist.get(coll)
        if hist is None:
            hist = acct.hist[coll] = [0] * bins
        idx = (dur_ns // 1000).bit_length()   # log2 bucket of the µs latency
        hist[min(idx, len(hist) - 1)] += 1


# ---------------------------------------------------------------------------
# Span ring: bounded per-thread records of program spans (off by default)
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    """One ring record. ``cpu_ns`` is the thread's CPU time over the span
    (``time.thread_time_ns``); wall less CPU is time off the CPU: waiting
    on a lock, the GIL or a peer, or preempted, which a span cannot tell
    apart. -1 where the span was opened without the CPU clock
    (``span_begin(cpu=False)``, the model step's phases). ``rank`` is the
    world rank, -1 on a thread outside every rank (autograd's device
    thread)."""
    rank: int
    thread: int
    name: str
    depth: int
    t0_ns: int
    t1_ns: int
    cpu_ns: int


class _Ring:
    __slots__ = ("buf", "dropped", "gen")

    def __init__(self, capacity: int, gen: int):
        self.buf: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.gen = gen


_spans_cap = 0                  # records kept a thread; 0: the ring is off
_rings_lock = threading.Lock()
_rings: List[_Ring] = []
_ring_gen = 0                   # bumped by spans_on: threads take new rings


def spans_on(capacity: int = 65536) -> None:
    """Start recording spans, at most ``capacity`` a thread (the oldest
    dropped first); drops what earlier rings held."""
    global _spans_cap, _rings, _ring_gen
    if capacity < 1:
        raise ValueError(f"span ring capacity {capacity} < 1")
    with _rings_lock:
        _ring_gen += 1
        _rings = []
        _spans_cap = int(capacity)


def spans_off() -> None:
    """Stop recording spans; what the rings hold stays for
    :func:`take_spans`."""
    global _spans_cap
    with _rings_lock:
        _spans_cap = 0


def take_spans() -> List[Span]:
    """Every thread's records, by start time (an outer span before the
    spans it holds), and clear the rings."""
    with _rings_lock:
        rings = list(_rings)
    out: List[Span] = []
    for ring in rings:
        buf = ring.buf
        for _ in range(len(buf)):
            out.append(buf.popleft())
    out.sort(key=lambda r: (r.t0_ns, r.depth))
    return out


def spans_dropped() -> int:
    """Records the rings dropped, full, since :func:`spans_on`."""
    with _rings_lock:
        return sum(r.dropped for r in _rings)


def span_begin(cpu: bool = True) -> Optional[Tuple[int, Optional[int], int]]:
    """Open a span on this thread: a token for :func:`span_end`, or None
    while the ring is off (one global read). ``cpu``: read the thread's
    CPU clock at both ends. A read is a system call (5-14 µs on the H100
    host the benchmark runs on, more when threads contend), so spans that
    only place work in time (where the card idles) pass False. Close it
    in a ``finally``: the token carries the depth it opened at, and
    closing restores it, so a span left open inside it by a raise is
    healed there."""
    if not _spans_cap:
        return None
    depth = _tls.depth
    _tls.depth = depth + 1
    return time.perf_counter_ns(), time.thread_time_ns() if cpu else None, depth


def span_end(name: str,
             token: Optional[Tuple[int, Optional[int], int]]) -> None:
    """Close the span ``token`` opened and record it as ``name``."""
    if token is None:
        return
    t0, c0, depth = token
    cpu = time.thread_time_ns() - c0 if c0 is not None else -1
    t1 = time.perf_counter_ns()
    _tls.depth = depth
    _record(name, depth, t0, t1, cpu)


def _record(name: str, depth: int, t0: int, t1: int, cpu: int) -> None:
    cap = _spans_cap
    if not cap:
        return
    ring = _tls.ring
    if ring is None or ring.gen != _ring_gen:
        ring = _tls.ring = _Ring(cap, _ring_gen)
        with _rings_lock:
            if ring.gen == _ring_gen:
                _rings.append(ring)
    if len(ring.buf) == ring.buf.maxlen:
        ring.dropped += 1
    env = _runtime.current_env()
    # the two clocks are read apart: CPU time over a span cannot pass its
    # wall time, so a difference of their readings is clipped
    ring.buf.append(Span(env[1] if env is not None else -1,
                         threading.get_ident(), name, depth, t0, t1,
                         min(cpu, t1 - t0) if cpu >= 0 else -1))


def _ring_op(sc: _OpScope, name: str, t1: float) -> None:
    """Put a closing op and its phases in the ring."""
    cpu = time.thread_time_ns() - sc.c0
    _tls.depth = sc.depth
    _record(name, sc.depth, int(sc.t0 * 1e9), int(t1 * 1e9), cpu)
    for (phase, s0, s1), c in zip(sc.spans, sc.cpu):
        _record(phase, sc.depth + 1, int(s0 * 1e9), int(s1 * 1e9), c)


class Phases:
    """Back-to-back phases of one step, each closed by :meth:`lap`: their
    nanoseconds by name in ``ns``, and with the ring on each a span (wall
    time alone) nested in one span ``outer`` over them all."""

    __slots__ = ("outer", "t0", "t", "depth", "ns")

    def __init__(self, outer: str):
        self.outer = outer
        self.ns: Dict[str, int] = {}
        self.depth = None
        if _spans_cap:
            self.depth = _tls.depth
            _tls.depth += 2          # spans inside a phase nest under it
        self.t0 = self.t = time.perf_counter_ns()

    def lap(self, name: str) -> None:
        """Close the phase that began at the last lap (or at the start)."""
        t = time.perf_counter_ns()
        self.ns[name] = self.ns.get(name, 0) + t - self.t
        if self.depth is not None:
            _record(name, self.depth + 1, self.t, t, -1)
        self.t = t

    def close(self) -> int:
        """End the step at the last lap; returns its nanoseconds. Call it
        in a ``finally``: it restores the thread's span depth."""
        if self.depth is not None:
            _tls.depth = self.depth
            _record(self.outer, self.depth, self.t0, self.t, -1)
        return self.t - self.t0


# -- test/debug latency shim (config.tune_shim) ------------------------------

_shim_cache: Tuple[Any, Optional[Dict[Tuple[str, str], float]]] = (_UNSET, None)


def _shim_map() -> Optional[Dict[Tuple[str, str], float]]:
    """Parsed ``tune_shim`` spec ("coll:algo=microseconds,...") as
    {(coll, algo): seconds}, or None when unset. Generation-cached: the
    default (empty) spec costs one tuple compare per op."""
    global _shim_cache
    cached_gen, val = _shim_cache
    if cached_gen == config.GENERATION:
        return val
    spec = config.load().tune_shim
    out: Optional[Dict[Tuple[str, str], float]] = None
    if spec:
        out = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, us = part.partition("=")
            coll, _, algo = key.partition(":")
            try:
                out[(coll.strip(), (algo or "star").strip())] = \
                    float(us) / 1e6
            except ValueError:
                pass
        out = out or None
    _shim_cache = (config.GENERATION, out)
    return out


def payload_nbytes(contrib: Any) -> Optional[int]:
    """Wire size of a collective contribution for the bandwidth counters
    (rooted contributions arrive as ``(root, payload)`` tuples)."""
    if isinstance(contrib, tuple) and len(contrib) == 2:
        contrib = contrib[1]
    nb = getattr(contrib, "nbytes", None)
    if nb is None:
        return None
    dt = getattr(contrib, "dtype", None)
    if dt is None or dt == object:
        return None
    return int(nb)


# ---------------------------------------------------------------------------
# Hot-path counter hooks (call sites gate on enabled())
# ---------------------------------------------------------------------------

def add_send(comm: Any, nbytes: int, wait_ns: int = 0) -> None:
    acct = _acct(comm)
    if acct is None:
        return
    with _store_lock:
        acct.sends += 1
        acct.bytes_sent += int(nbytes or 0)
        acct.wait_ns += int(wait_ns)


def add_recv(comm: Any, nbytes: int, wait_ns: int = 0) -> None:
    acct = _acct(comm)
    if acct is None:
        return
    with _store_lock:
        acct.recvs += 1
        acct.bytes_recv += int(nbytes or 0)
        acct.wait_ns += int(wait_ns)


def add_wait(wait_s: float, comm: Any = None, cid: Optional[int] = None) -> None:
    """Time blocked in the Wait/Test family (unattributed waits land on the
    pseudo-cid -1)."""
    acct = _acct(comm, cid=cid)
    if acct is None:
        return
    with _store_lock:
        acct.wait_ns += int(wait_s * 1e9)


# -- wait-time ownership (the outermost-owner rule for wait_ns) -------------
#
# A persistent collective round is fully accounted by the op scope its
# worker (or the inline registered fast path) owns: the round's wall clock
# lands in ``times`` and its blocked share in the ``rendezvous`` phase.
# The caller blocked in ``Wait`` covers the SAME wall clock, so letting the
# inner ``CollRequest.wait`` also bump ``wait_ns`` double-counts it — the
# overhead_probe --pvars bug. ``PersistentCollRequest`` claims
# ownership around its inner wait; nested add_wait callers check
# :func:`wait_owned` first and stand down.

def own_wait() -> bool:
    """Claim wait-time ownership for this thread. Returns True when the
    claim is fresh (caller must :func:`disown_wait` in a finally); False
    when an outer owner already holds it."""
    if _tls.wait_owned:
        return False
    _tls.wait_owned = True
    return True


def disown_wait() -> None:
    """Release the wait-time claim taken by :func:`own_wait`."""
    _tls.wait_owned = False


def wait_owned() -> bool:
    """True while an outer wait-time owner is on this thread's stack —
    nested waits must not call :func:`add_wait`."""
    return _tls.wait_owned


def note_rma(comm: Any, kind: str) -> None:
    """One RMA epoch event: kind in {fence, lock, flush}."""
    acct = _acct(comm)
    if acct is None:
        return
    with _store_lock:
        if kind in acct.rma:
            acct.rma[kind] += 1


def note_pipelined(cid: int, nchunks: int, fold_ns: int,
                   wait_after_first_ns: int) -> None:
    """One chunk-pipelined star fold at the root: the overlap-fraction
    inputs (fold time vs rendezvous waits AFTER the first chunk — waits
    that a perfectly overlapped pipeline hides behind the fold)."""
    acct = _acct(cid=cid)
    if acct is None:
        return
    with _store_lock:
        acct.pipe_ops += 1
        acct.pipe_chunks += int(nchunks)
        acct.pipe_fold_ns += int(fold_ns)
        acct.pipe_wait_ns += int(wait_after_first_ns)


def note_batch(cid: int, nops: int) -> None:
    """One batched-submission flush on this comm: ``nops``
    queued ops went through one rendezvous round trip."""
    acct = _acct(cid=cid)
    if acct is None:
        return
    with _store_lock:
        acct.batch_flushes += 1
        acct.batch_ops += int(nops)


# -- inference-engine block (tpu_mpi_torch.infer) ----------------------------------
#
# Process-global (the engine spans every pool rank, so per-comm attribution
# would just smear one logical step over three comms): counters accumulate,
# gauges overwrite. Snapshot surfaces them as the top-level "infer" block
# next to plan_cache.

_infer: Dict[str, int] = {}
_infer_gauges: Dict[str, int] = {}


def note_infer(**counts: int) -> None:
    """Accumulate inference-engine counters (steps, tokens, batch_slots,
    prefills, step_ns, pwait_ns, stage_serial_ns, slo_hits/misses/
    evictions, ...)."""
    with _store_lock:
        for k, v in counts.items():
            _infer[k] = _infer.get(k, 0) + int(v)


def set_infer_gauges(**vals: int) -> None:
    """Overwrite inference-engine gauges (KV pressure, max_batch)."""
    with _store_lock:
        for k, v in vals.items():
            _infer_gauges[k] = int(v)


def infer_snapshot() -> dict:
    """The infer block of :func:`snapshot` (may be empty): accumulated
    counters plus the latest gauges under ``"gauges"``."""
    with _store_lock:
        if not _infer and not _infer_gauges:
            return {}
        return {**_infer, "gauges": dict(_infer_gauges)}


# -- training block (tpu_mpi_torch.train) ------------------------------------------
#
# Process-global like the infer block: a training step spans every rank of
# the job, and the trainer lives above any single comm. Counters (steps,
# buckets, bucket_flushes, starts, waits, reshards, wait_ns,
# comm_window_ns, step_ns) accumulate; gauges (nbuckets, bucket_bytes,
# world) overwrite. A bounded per-step sample list feeds the stats
# renderer's p50/p99 without unbounded growth.

_train: Dict[str, int] = {}
_train_gauges: Dict[str, int] = {}
_train_steps: List[int] = []
_TRAIN_STEP_CAP = 4096


def note_train(**counts: int) -> None:
    """Accumulate training counters (steps, bucket_flushes, starts,
    waits, reshards, wait_ns, comm_window_ns, step_ns, ...)."""
    with _store_lock:
        for k, v in counts.items():
            _train[k] = _train.get(k, 0) + int(v)


def set_train_gauges(**vals: int) -> None:
    """Overwrite training gauges (nbuckets, bucket_bytes, world)."""
    with _store_lock:
        for k, v in vals.items():
            _train_gauges[k] = int(v)


def note_train_step(ns: int) -> None:
    """Record one optimizer-step duration sample (nanoseconds) for the
    p50/p99 rendering; also accumulates steps/step_ns counters."""
    with _store_lock:
        _train["steps"] = _train.get("steps", 0) + 1
        _train["step_ns"] = _train.get("step_ns", 0) + int(ns)
        if len(_train_steps) < _TRAIN_STEP_CAP:
            _train_steps.append(int(ns))


def train_snapshot() -> dict:
    """The train block of :func:`snapshot` (may be empty): accumulated
    counters, latest gauges under ``"gauges"``, and the bounded step-time
    sample list under ``"step_ns_samples"``."""
    with _store_lock:
        if not _train and not _train_gauges:
            return {}
        return {**_train, "gauges": dict(_train_gauges),
                "step_ns_samples": list(_train_steps)}


# -- model-step block (tpu_mpi_torch.models) ----------------------------------------
#
# Process-global like the train block: the in-graph step holds every rank
# of its mesh in one call. Counters: steps, step_ns and the four phases
# that tile a step, forward_ns, backward_ns, grad_sum_ns, update_ns; the
# Moonlight step's MoE layers add, summed over layer-steps, moe_layers,
# moe_routed_rows, moe_exchanged_rows and moe_exchanged_bytes (the
# forward's two exchanges, padding included), moe_rows_max (the busiest
# expert's rows) and moe_expert_slots (experts a layer).

_model: Dict[str, int] = {}


def note_model(**counts: int) -> None:
    """Accumulate model-step counters."""
    with _store_lock:
        for k, v in counts.items():
            _model[k] = _model.get(k, 0) + int(v)


def model_snapshot() -> dict:
    """The model block of :func:`snapshot` (may be empty)."""
    with _store_lock:
        return dict(_model)


# -- elastic-capacity block (tpu_mpi_torch.elastic) ---------------------------------
#
# Process-global like the infer block: resizes span the whole pool, so
# per-comm attribution is meaningless. Counters (resizes, rebinds, grown,
# shrunk, failures) accumulate; gauges (pool_size, target_size, degraded)
# overwrite.

_elastic: Dict[str, int] = {}
_elastic_gauges: Dict[str, int] = {}


def note_elastic(**counts: int) -> None:
    """Accumulate elastic-capacity counters (resizes, rebinds, grown,
    shrunk, failures, ...)."""
    with _store_lock:
        for k, v in counts.items():
            _elastic[k] = _elastic.get(k, 0) + int(v)


def set_elastic_gauges(**vals: int) -> None:
    """Overwrite elastic-capacity gauges (pool_size, target_size,
    degraded)."""
    with _store_lock:
        for k, v in vals.items():
            _elastic_gauges[k] = int(v)


def elastic_snapshot() -> dict:
    """The elastic block of :func:`snapshot` (may be empty): accumulated
    counters plus the latest gauges under ``"gauges"``."""
    with _store_lock:
        if not _elastic and not _elastic_gauges:
            return {}
        return {**_elastic, "gauges": dict(_elastic_gauges)}


# -- serve frame-path block (tpu_mpi_torch.serve) ----------------------------------
#
# Process-global like the infer block: the session/mailbox frame path spans
# every tenant connection, so per-comm attribution would smear one wire hop
# over many comms. ``ops`` counts OP/RESULT frames carrying array payloads,
# ``copies`` counts payload materializations (ascontiguousarray / tobytes /
# non-view marshalling) on that path — the zero-copy acceptance gate is
# copies/ops <= 1 — ``sg_writes`` counts scatter-gather sendmsg calls and
# ``zc_bytes`` the payload bytes that travelled as views.

_serve_frame: Dict[str, int] = {}


def note_serve_frame(**counts: int) -> None:
    """Accumulate serve frame-path counters (ops, copies, sg_writes,
    zc_bytes, ...)."""
    with _store_lock:
        for k, v in counts.items():
            _serve_frame[k] = _serve_frame.get(k, 0) + int(v)


def serve_frame_snapshot() -> dict:
    """The serve_frame block of :func:`snapshot` (may be empty)."""
    with _store_lock:
        return dict(_serve_frame)


# -- front-door block (tpu_mpi_torch.serve.frontdoor) ------------------------------
#
# Process-global like the serve_frame block: the event-driven session
# transport multiplexes every attached socket on one readiness loop, so
# per-comm attribution would smear loop mechanics over tenants. Counters
# accumulate (attaches, wakeups, frames, lease_hits/lease_misses/
# lease_drops, splice_bytes); gauges overwrite (open_sockets, workers,
# workers_busy).

_front_door: Dict[str, int] = {}
_front_door_gauges: Dict[str, int] = {}


def note_front_door(**counts: int) -> None:
    """Accumulate front-door counters (attaches, wakeups, frames,
    lease_hits, lease_misses, lease_drops, splice_bytes, ...)."""
    with _store_lock:
        for k, v in counts.items():
            _front_door[k] = _front_door.get(k, 0) + int(v)


def set_front_door_gauges(**vals: int) -> None:
    """Overwrite front-door gauges (open_sockets, workers, workers_busy)."""
    with _store_lock:
        for k, v in vals.items():
            _front_door_gauges[k] = int(v)


def front_door_snapshot() -> dict:
    """The front_door block of :func:`snapshot` (may be empty): accumulated
    counters plus the latest gauges under ``"gauges"``."""
    with _store_lock:
        if not _front_door and not _front_door_gauges:
            return {}
        return {**_front_door, "gauges": dict(_front_door_gauges)}


# -- lock-contention block (tpu_mpi_torch.locksmith) -------------------------------
#
# Populated only when the lock witness is armed (TPU_MPI_LOCKCHECK=1):
# per named lock, how many acquisitions there were, how many had to wait
# behind another holder, and the longest single hold in nanoseconds.
# Process-global like the serve_frame block — lock names already carry
# their subsystem (``broker.dispatch``, ``pool.queues``, ...).

_locks: Dict[str, Dict[str, int]] = {}


def note_lock(name: str, acquires: int = 0, contended: int = 0,
              held_ns: int = 0) -> None:
    """Accumulate contention counters for one named lock. ``held_ns`` is
    a single observed hold time; the block keeps the max."""
    with _store_lock:
        row = _locks.get(name)
        if row is None:
            row = _locks[name] = {"acquires": 0, "contended": 0,
                                  "max_held_ns": 0}
        row["acquires"] += int(acquires)
        row["contended"] += int(contended)
        if held_ns > row["max_held_ns"]:
            row["max_held_ns"] = int(held_ns)


def locks_snapshot() -> dict:
    """The locks block of :func:`snapshot` (empty when the witness is off)."""
    with _store_lock:
        return {k: dict(v) for k, v in _locks.items()}


def note_explore(comm: Any, explored: bool) -> None:
    """One online-autotuner decision on this comm (tpu_mpi_torch.tune_online):
    ``explored`` when the call was routed to an alternate arm."""
    acct = _acct(comm)
    if acct is None:
        return
    with _store_lock:
        acct.explore_calls += 1
        if explored:
            acct.explore_explored += 1


def note_swap(comm: Any, generation: int) -> None:
    """One online table hot-swap on this comm."""
    acct = _acct(comm)
    if acct is None:
        return
    with _store_lock:
        acct.table_swaps += 1
        acct.last_swap_gen = int(generation)


def arm_stats(comm: Any) -> List[Tuple[str, str, int, int, int]]:
    """This rank's accumulated latency stats on one comm as
    ``(coll, algo, nbytes, count, total_ns)`` rows — the payload the
    online autotuner's lockstep swap round allgathers so that every rank
    merges the IDENTICAL cross-rank arm statistics."""
    from ._runtime import current_env
    env = current_env()
    if env is None:
        return []
    key = (env[1], comm.cid)
    with _store_lock:
        acct = _store.get(key)
        if acct is None:
            return []
        return [(c, a, b, t[0], t[1])
                for (c, a, b), t in sorted(acct.times.items())]


def frontdoor_totals(coll: str = "allreduce") -> dict:
    """One collective's front-door totals, summed over this process's
    ranks and comms, as one flat dict: ``ops`` (rank-ops) and ``op_ns``
    from ``times``, ``<phase>_ns`` for each of :data:`OP_PHASES`, and the
    plan cache's and the auto-armed lane's hits and misses."""
    from .overlap import plans
    out = {"ops": 0, "op_ns": 0, **{f"{p}_ns": 0 for p in OP_PHASES}}
    with _store_lock:
        for acct in _store.values():
            for (c, _, _), t in acct.times.items():
                if c == coll:
                    out["ops"] += t[0]
                    out["op_ns"] += t[1]
            for p, ns in acct.coll_phase_ns.get(coll, {}).items():
                out[f"{p}_ns"] += ns
    st = plans.stats()
    out.update(plan_hits=st["hits"], plan_misses=st["misses"],
               auto_hits=st["auto"]["hits"], auto_arms=st["auto"]["arms"],
               auto_demotions=st["auto"]["demotions"])
    return out


def kernels_snapshot() -> dict:
    """The kernels block of :func:`snapshot`: the kernel layer's table of
    builds, loads and launch counts (``kernels._build.counts``)."""
    from .kernels._build import counts
    return counts.snapshot()


# ---------------------------------------------------------------------------
# Snapshot / reset / dump
# ---------------------------------------------------------------------------

def _topology_stamp() -> str:
    """The ``topology_key`` of the world these counters describe — stamped
    into every dump record so ``tune merge`` can attribute samples to the
    right fabric without a side channel. Derived from the live context
    (domain map over the full world) when one is attached, else from
    config alone (a flat default — better unstamped-conservative than
    wrong)."""
    from . import topology as _topo
    try:
        from ._runtime import current_env
        env = current_env()
        if env is not None:
            ctx = env[0]
            n = int(getattr(ctx, "size", 0) or 0)
            if n >= 2:
                dom = _topo.domain_count(ctx, tuple(range(n)))
                return _topo.topology_key(dom, n)
    except Exception:
        pass
    return _topo.topology_key(int(config.load().domains), 0)


def snapshot(rank: Optional[int] = None, reset: bool = False) -> dict:
    """Machine-readable dump of every counter (one rank, or all ranks this
    process has accumulated). Stable schema — ``tpu_mpi_torch.stats`` and
    ``tune.table_from_pvars`` consume exactly this."""
    global _store_gen
    from .overlap import plans
    with _store_lock:
        # cids mix ints and recovery tuples (("shrink", cid, epoch)) in one
        # store — sort through str so the dump order is still deterministic
        keys = [k for k in sorted(_store, key=lambda k: (k[0], str(k[1])))
                if rank is None or k[0] == rank]
        comms = [_store[k].snapshot() for k in keys]
        if reset:
            for k in keys:
                del _store[k]
            _store_gen += 1
    return {"schema": 1, "kind": "tpu_mpi_torch-pvars", "level": level(),
            "topology": _topology_stamp(),
            "comms": comms, "plan_cache": plans.stats(),
            "infer": infer_snapshot(), "train": train_snapshot(),
            "model": model_snapshot(), "kernels": kernels_snapshot(),
            "elastic": elastic_snapshot(),
            "serve_frame": serve_frame_snapshot(),
            "front_door": front_door_snapshot(),
            "locks": locks_snapshot()}


def comm_snapshot(comm: Any, reset: bool = False) -> dict:
    """``Comm.get_pvars`` backend: this rank's counters on one comm."""
    global _store_gen
    from ._runtime import require_env
    _, rank = require_env()
    key = (rank, comm.cid)
    with _store_lock:
        acct = _store.get(key)
        snap = acct.snapshot() if acct is not None \
            else CommPvars(rank, comm.cid).snapshot()
        if reset and acct is not None:
            del _store[key]
            _store_gen += 1
    return snap


def reset() -> None:
    """Drop every accumulated counter (all ranks of this process)."""
    global _store_gen
    with _store_lock:
        _store.clear()
        _infer.clear()
        _infer_gauges.clear()
        _train.clear()
        _train_gauges.clear()
        _train_steps.clear()
        _model.clear()
        _elastic.clear()
        _elastic_gauges.clear()
        _serve_frame.clear()
        _front_door.clear()
        _front_door_gauges.clear()
        _locks.clear()
        _store_gen += 1


def dump(path: str, rank: Optional[int] = None, reset: bool = False) -> str:
    """Write :func:`snapshot` as JSON; returns the path."""
    rec = snapshot(rank=rank, reset=reset)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_dumps(paths) -> List[dict]:
    """Read pvar dump records from files and/or directories (a directory
    contributes every ``pvars-rank*.json`` / ``*.json`` file in it).
    Consumers: ``tpu_mpi_torch.stats`` and ``tune.table_from_pvars``."""
    files: List[str] = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            names = sorted(os.listdir(p))
            picked = [n for n in names if n.startswith("pvars-rank")
                      and n.endswith(".json")]
            files.extend(os.path.join(p, n) for n in
                         (picked or [n for n in names if n.endswith(".json")]))
        else:
            files.append(p)
    recs = []
    for f in files:
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("kind") != "tpu_mpi_torch-pvars":
            raise ValueError(f"{f}: not a tpu_mpi_torch pvar dump")
        rec["_path"] = f
        recs.append(rec)
    return recs


def finalize_dump(force: bool = False) -> Optional[str]:
    """Per-rank dump at Finalize (and at ``Pcontrol(level >= 2)``): when
    ``config.pvars_dump`` names a directory, this rank writes
    ``pvars-rank<R>.json`` there. Costs one branch when pvars are off."""
    if not (enabled() or force):
        return None
    from ._runtime import current_env
    d = config.load().pvars_dump
    if not d:
        return None
    env = current_env()
    rank = env[1] if env is not None else 0
    return dump(os.path.join(os.path.expanduser(d), f"pvars-rank{rank}.json"),
                rank=rank)


# last: _runtime imports this module (the ring reads its current_env)
from . import _runtime  # noqa: E402
