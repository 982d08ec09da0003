"""Per-rank communication event recording (the trace verifier's front end).

When tracing is on (config knob ``trace`` / env ``TPU_MPI_TRACE``), the hot
paths in ``comm``/``collective``/``pointtopoint``/``onesided`` call the
``record_*`` hooks below, which append :class:`Event` records into per-rank
ring buffers on one :class:`Tracer` attached to the :class:`SpmdContext`.
The rings are consumed by :func:`tpu_mpi_torch.analyze.matcher.verify_trace` (cross-
rank order/signature checks + send/recv pairing), by
:func:`tpu_mpi_torch.analyze.races.detect_races` (vector-clock happens-before over
window epochs), and by the DeadlockError dump
(:func:`tpu_mpi_torch.analyze.matcher.deadlock_report`).

Overhead discipline: every hook front-loads :func:`enabled` — one tuple
compare against ``config.GENERATION`` — so an untraced run pays a single
predictable branch per operation. All heavier imports (numpy, config) stay
inside the traced branch.

Vector clocks are plain ``{origin_rank: counter}`` dicts rather than fixed
arrays so a world grown by ``Comm_spawn`` keeps working without resizing.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import zlib

from .. import config
from collections import deque
from typing import Any, Dict, Optional, Tuple

# first source directory outside this package wins as the "call site"
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STDLIB_DIR = os.path.dirname(threading.__file__)

_mod_lock = threading.Lock()

# the most recently created Tracer: testing.run_spmd tears the ctx down
# before returning, so post-run verification reaches the trace through here.
last_tracer: Optional["Tracer"] = None


def last_trace() -> Optional["Tracer"]:
    """The Tracer of the most recent traced run (or None)."""
    return last_tracer


# Sentinel initial generation: None can never equal config.GENERATION (an
# int), so the very first call populates the cache and every later call is
# one tuple compare — including at GENERATION == 0, where the old `gen != 0`
# guard forced a config.load() per call until the first refresh bump.
_UNSET = object()
_enabled_cache: Tuple[Any, bool] = (_UNSET, False)


def enabled() -> bool:
    """Whether event tracing is on — cached on ``config.GENERATION`` so the
    per-operation cost of an untraced run is one tuple compare."""
    global _enabled_cache
    cached_gen, val = _enabled_cache
    if cached_gen == config.GENERATION:
        return val
    val = bool(config.load().trace)
    _enabled_cache = (config.GENERATION, val)
    return val


def call_site(skip: int = 2) -> Tuple[str, int]:
    """(file, line) of the first frame outside tpu_mpi_torch — the user's call.

    Returns ``("<unknown>", 0)`` when every frame is internal (e.g. the
    nonblocking-collective worker threads, whose stacks bottom out in
    ``threading``)."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ("<unknown>", 0)
    depth = 0
    while f is not None and depth < 50:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR):
            if fn.startswith(_STDLIB_DIR) or fn.startswith("<"):
                return ("<unknown>", 0)
            return (fn, f.f_lineno)
        f = f.f_back
        depth += 1
    return ("<unknown>", 0)


class Event:
    """One recorded communication operation (the shared IR of all passes)."""

    __slots__ = ("kind", "rank", "op", "cid", "seq", "peer", "root", "tag",
                 "count", "dtype", "win", "lo", "hi", "vc", "origin", "grp",
                 "algo", "file", "line", "t",
                 # pvar span fields (perfvars.op_end stamps them): wall-clock
                 # bracket of the whole op plus the phase spans the channels
                 # observed inside it, as (name, t0, t1) perf_counter tuples —
                 # analyze.timeline renders these as nested Perfetto slices.
                 "t_start", "t_end", "phases",
                 # schedule-exploration fields: the POSTED source/tag of a
                 # receive (None = wildcard; `peer`/`tag` hold the delivered
                 # values), the persistent-request handle + round a
                 # start/wait/coll event belongs to, the identity of the
                 # user buffer an op read (R302), and a grab-bag dict for
                 # ft/serve records (epoch, survivors, books, ...).
                 "want", "wtag", "handle", "round", "bufid", "extra")

    def __init__(self, kind: str, rank: int, **kw: Any):
        # "coll" | "send" | "recv" | "rma" | "sync" | "start" | "wait"
        # | "ft" | "serve" | "elastic"
        self.kind = kind
        self.rank = rank          # world rank of the recording rank
        for name in self.__slots__[2:]:
            setattr(self, name, kw.get(name))
        if self.t is None:
            self.t = time.perf_counter()

    def describe(self) -> str:
        """Human-readable one-liner (used by the deadlock dump)."""
        if self.kind == "coll":
            return f"{self.op} on comm {self.cid}"
        if self.kind in ("send", "recv"):
            peer = "ANY_SOURCE" if self.peer is None else self.peer
            return (f"{self.op}(peer=world rank {peer}, tag={self.tag}) "
                    f"on comm {self.cid}")
        if self.kind == "rma":
            return (f"{self.op}(target=world rank {self.peer}, "
                    f"range=[{self.lo}, {self.hi}))")
        if self.kind in ("start", "wait"):
            return f"{self.op} [{self.kind} round {self.round}] on comm {self.cid}"
        if self.kind in ("ft", "elastic"):
            return f"{self.op} on comm {self.cid} ({self.extra})"
        return f"{self.op}"

    def __repr__(self) -> str:
        return (f"<Event {self.kind} r{self.rank} {self.describe()} "
                f"seq={self.seq} at {self.file}:{self.line}>")


class Tracer:
    """Per-context event store: one ring buffer per world rank, plus the
    cross-rank synchronization state the RMA vector-clock pass needs."""

    def __init__(self, nprocs: int, cap: int):
        self.nprocs = nprocs
        self.cap = max(16, int(cap))
        self.lock = threading.RLock()
        self.rings: Dict[int, deque] = {}          # rank -> deque[Event]
        # absolute per-(rank, kind, cid) ordinals: matcher alignment stays
        # correct even after the ring evicted early events.
        self.counts: Dict[tuple, int] = {}
        self.dropped: Dict[int, int] = {}          # rank -> evicted events
        self.blocked: Dict[int, Event] = {}        # rank -> current block
        self.diagnostics: list = []                # online findings (T206)
        # RMA pass state — rma_events is global-ordered (append order is the
        # real interleaving on the thread tier) and larger than the rings:
        # races need the full epoch, not a window.
        self.rma_events: deque = deque(maxlen=65536)
        self._vc: Dict[int, Dict[int, int]] = {}   # rank -> vector clock
        self._fence_round: Dict[tuple, int] = {}   # (rank, win) -> round no.
        self._fence_acc: Dict[tuple, dict] = {}    # (win, round) -> joined vc
        self._excl_release: Dict[tuple, dict] = {}  # (win, target) -> vc
        self._shared_accum: Dict[tuple, dict] = {}  # (win, target) -> vc

    def record(self, ev: Event) -> Event:
        with self.lock:
            ring = self.rings.get(ev.rank)
            if ring is None:
                ring = self.rings[ev.rank] = deque(maxlen=self.cap)
            key = (ev.rank, ev.kind, ev.cid)
            ev.seq = self.counts.get(key, 0)
            self.counts[key] = ev.seq + 1
            if len(ring) == ring.maxlen:
                self.dropped[ev.rank] = self.dropped.get(ev.rank, 0) + 1
            ring.append(ev)
        return ev

    def events(self, rank: Optional[int] = None):
        """Snapshot of recorded events (one rank, or all ranks merged)."""
        with self.lock:
            if rank is not None:
                return list(self.rings.get(rank, ()))
            out = []
            for r in sorted(self.rings):
                out.extend(self.rings[r])
            return out


def tracer_for(ctx: Any, create: bool = False) -> Optional[Tracer]:
    """The context's Tracer, lazily attached on first recorded event."""
    tr = getattr(ctx, "_tracer", None)
    if tr is None and create:
        global last_tracer
        with _mod_lock:
            tr = getattr(ctx, "_tracer", None)
            if tr is None:
                cfg = config.load()
                tr = Tracer(getattr(ctx, "size", 0), cfg.trace_buffer)
                ctx._tracer = tr
            last_tracer = tr
    return tr


def _env() -> Optional[tuple]:
    from .._runtime import current_env
    return current_env()


# ---------------------------------------------------------------------------
# Recording hooks (called from comm/collective/pointtopoint/onesided)
# ---------------------------------------------------------------------------

# persistent-request round tagging: while a traced persistent round runs its
# legacy collective lane, the inner record_collective event is stamped with
# the owning handle so analyze.explore models the round's timing from the
# start/wait pair instead of double-counting the inner event.
_tls = threading.local()


class persistent_scope:
    """Context manager marking collective events recorded inside it as
    belonging to one persistent handle's round."""

    def __init__(self, handle: int, rnd: int):
        self._tag = (handle, rnd)

    def __enter__(self):
        _tls.phandle = self._tag
        return self

    def __exit__(self, *exc):
        _tls.phandle = None
        return False


def dtype_name(dtype: Any) -> Optional[str]:
    """An element type as the trace records it: numpy's name (``float32``,
    ``bfloat16``), whether the operand was a numpy array, a CPU tensor or
    a CUDA tensor, so ranks that pass different kinds of one type agree."""
    if dtype is None:
        return None
    return str(dtype).removeprefix("torch.")


def _datatype_name(dtype: Any) -> Optional[str]:
    """A send's Datatype as the trace records it: a tensor's predefined
    type under numpy's name, as a numpy operand's reads."""
    if dtype is None:
        return None
    from ..datatypes import _TORCH_TO_DATATYPE
    for t, dt in _TORCH_TO_DATATYPE.items():
        if dtype is dt:
            return (f"<Datatype {dtype_name(t)} size={dt.size_bytes} "
                    f"extent={dt.extent_bytes}>")
    return str(dtype)


def record_collective(comm: Any, opname: str,
                      sig: Optional[dict] = None) -> Optional[Event]:
    """One collective entry on this rank; ``sig`` carries the cross-rank-
    checkable signature fields (root/dtype/count, plus per-peer
    scounts/rcounts for the ``*v`` family) when the caller knows them
    precisely (reductions, Bcast, Alltoallv)."""
    env = _env()
    if env is None:
        return None
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    sig = sig or {}
    f, ln = call_site()
    ptag = getattr(_tls, "phandle", None)
    extra = {k: list(sig[k]) for k in ("scounts", "rcounts") if k in sig}
    ev = Event("coll", wrank, op=str(opname), cid=comm.cid,
               grp=tuple(comm.group), root=sig.get("root"),
               dtype=dtype_name(sig.get("dtype")), count=sig.get("count"),
               algo=sig.get("algo"), bufid=sig.get("bufid"),
               handle=ptag[0] if ptag else None,
               round=ptag[1] if ptag else None,
               file=f, line=ln, extra=extra or None)
    return tr.record(ev)


def record_send(comm: Any, dest: int, tag: Any, count: Any, dtype: Any,
                op: str = "Send", buf: Any = None) -> Optional[Event]:
    env = _env()
    if env is None:
        return None
    ctx, wrank = env
    try:
        peer = comm.world_rank_of(int(dest))
    except Exception:
        return None
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    ev = Event("send", wrank, op=op, cid=comm.cid, peer=peer,
               tag=tag if isinstance(tag, tuple) else int(tag),
               count=count, dtype=_datatype_name(dtype),
               bufid=buf_id(buf), file=f, line=ln)
    return tr.record(ev)


_POSTED_UNKNOWN = object()


def record_recv(comm: Any, msg: Any, op: str = "Recv",
                want: Any = _POSTED_UNKNOWN,
                wtag: Any = _POSTED_UNKNOWN) -> Optional[Event]:
    """One completed receive; ``msg`` is the delivered runtime Message
    (``msg.src`` is the sender's comm rank). ``want``/``wtag`` are the
    POSTED source/tag — ``None`` meaning ANY_SOURCE/ANY_TAG — which the
    schedule explorer re-enumerates; callers that don't know them (old
    call sites) leave the defaults and the posted values degrade to the
    delivered ones."""
    env = _env()
    if env is None:
        return None
    ctx, wrank = env
    try:
        peer = comm.world_rank_of(int(msg.src))
    except Exception:
        peer = None
    if want is _POSTED_UNKNOWN:
        posted_src = peer
    elif want is None:
        posted_src = None
    else:
        try:
            posted_src = comm.world_rank_of(int(want))
        except Exception:
            posted_src = peer
    posted_tag = msg.tag if wtag is _POSTED_UNKNOWN else wtag
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    ev = Event("recv", wrank, op=op, cid=comm.cid, peer=peer, tag=msg.tag,
               count=msg.count, want=posted_src, wtag=posted_tag,
               file=f, line=ln)
    return tr.record(ev)


# ---------------------------------------------------------------------------
# Blocked-operation tracking (feeds the DeadlockError dump)
# ---------------------------------------------------------------------------

def blocked_event(comm: Any, kind: str, op: str, peer: Optional[int] = None,
                  tag: Any = None) -> Optional[Event]:
    """An Event describing an operation about to block — NOT recorded into
    the ring (it has not completed); pass to :func:`set_blocked`."""
    env = _env()
    if env is None:
        return None
    _, wrank = env
    world_peer = None
    if peer is not None:
        try:
            world_peer = comm.world_rank_of(int(peer))
        except Exception:
            world_peer = None
    f, ln = call_site()
    return Event(kind, wrank, op=op, cid=getattr(comm, "cid", None),
                 grp=tuple(getattr(comm, "group", ())) or None,
                 peer=world_peer, tag=tag, file=f, line=ln)


def set_blocked(ctx: Any, ev: Optional[Event]) -> None:
    if ev is None:
        return
    tr = tracer_for(ctx, create=True)
    with tr.lock:
        tr.blocked[ev.rank] = ev


def clear_blocked(ctx: Any, ev: Optional[Event]) -> None:
    if ev is None:
        return
    tr = tracer_for(ctx)
    if tr is None:
        return
    with tr.lock:
        if tr.blocked.get(ev.rank) is ev:
            del tr.blocked[ev.rank]


# ---------------------------------------------------------------------------
# Isend buffer-reuse check (T206)
# ---------------------------------------------------------------------------

def _buf_crc(buf: Any) -> Optional[int]:
    """crc32 of an Isend buffer's bytes as they stand, or None for a
    payload numpy cannot read. A tensor (or a DeviceBuffer's) is read where
    it lies: detached, bfloat16 as its raw bits, a CUDA tensor through one
    device-to-host copy; the crc is what numpy's bytes of the same values
    give."""
    import torch

    from ..buffers import DeviceBuffer
    if isinstance(buf, DeviceBuffer):
        buf = buf.value
    if isinstance(buf, torch.Tensor):
        t = buf.detach().resolve_conj().resolve_neg()
        if t.device.type != "cpu":
            t = t.cpu()
        return zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8).numpy())
    try:
        import numpy as np
        arr = np.ascontiguousarray(np.asarray(buf))
        return zlib.crc32(arr.tobytes())
    except Exception:
        return None


def note_isend(req: Any, comm: Any, buf: Any) -> None:
    """Checksum an Isend's user buffer at post time; :func:`check_isend`
    re-checksums at Wait and reports T206 on mutation."""
    crc = _buf_crc(buf)
    if crc is None:
        return
    try:
        req._trace_isend = (call_site(), crc, buf)
        req._trace_comm = comm
    except Exception:
        pass


def check_isend(ctx: Any, req: Any) -> None:
    noted = getattr(req, "_trace_isend", None)
    if noted is None:
        return
    req._trace_isend = None
    (f, ln), crc, buf = noted
    now = _buf_crc(buf)
    if now is None or now == crc:
        return
    tr = tracer_for(ctx, create=True)
    from .diagnostics import Diagnostic
    env = _env()
    with tr.lock:
        tr.diagnostics.append(Diagnostic(
            "T206", "Isend buffer was modified before its Wait completed",
            file=f, line=ln, rank=env[1] if env else None,
            context="checksum at post != checksum at Wait"))


# ---------------------------------------------------------------------------
# RMA: vector-clock bookkeeping over window epochs (R301 front end)
# ---------------------------------------------------------------------------

def _win_key(win: Any) -> int:
    # _WinState is the one object all ranks of the window share on the
    # thread tier, so its id names the window across ranks.
    return id(getattr(win, "_state", win))


def _join_into(dst: Dict[int, int], src: Optional[Dict[int, int]]) -> None:
    if not src:
        return
    for k, v in src.items():
        if dst.get(k, 0) < v:
            dst[k] = v


def rma_access(win: Any, kind: str, target_world: int, lo: int,
               hi: int) -> None:
    """One origin-side Put/Get/Accumulate touching ``[lo, hi)`` elements of
    ``target_world``'s window — stamped with the origin's vector clock."""
    env = _env()
    if env is None:
        return
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    with tr.lock:
        vc = tr._vc.setdefault(wrank, {})
        vc[wrank] = vc.get(wrank, 0) + 1
        ev = Event("rma", wrank, op=kind, win=_win_key(win),
                   peer=int(target_world), lo=int(lo), hi=int(hi),
                   vc=dict(vc), origin=wrank, file=f, line=ln)
        tr.rma_events.append(ev)
        tr.record(ev)    # also in the per-rank ring (deadlock-dump context)


def fence_begin(win: Any) -> None:
    """Entering Win_fence: contribute this rank's clock to the fence's
    accumulator. Sound because the fence's barrier orders every begin
    before any end."""
    env = _env()
    if env is None:
        return
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    wk = _win_key(win)
    with tr.lock:
        rnd = tr._fence_round.get((wrank, wk), 0)
        acc = tr._fence_acc.setdefault((wk, rnd), {})
        _join_into(acc, tr._vc.setdefault(wrank, {}))


def fence_end(win: Any) -> None:
    """Leaving Win_fence: join the accumulated clock of ALL ranks' pre-fence
    work into this rank's clock; later accesses happen-after every access of
    the previous epoch, on every rank."""
    env = _env()
    if env is None:
        return
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    wk = _win_key(win)
    with tr.lock:
        rnd = tr._fence_round.get((wrank, wk), 0)
        _join_into(tr._vc.setdefault(wrank, {}), tr._fence_acc.get((wk, rnd)))
        tr._fence_round[(wrank, wk)] = rnd + 1


def lock_acquired(win: Any, target_world: int, excl: bool) -> None:
    """After a Win_lock acquires: an exclusive lock happens-after every prior
    release of this (window, target); a shared lock happens-after prior
    EXCLUSIVE releases only — concurrent shared holders stay concurrent, so
    racing accesses under shared locks are still flagged."""
    env = _env()
    if env is None:
        return
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    key = (_win_key(win), int(target_world))
    with tr.lock:
        vc = tr._vc.setdefault(wrank, {})
        _join_into(vc, tr._excl_release.get(key))
        if excl:
            _join_into(vc, tr._shared_accum.get(key))
        vc[wrank] = vc.get(wrank, 0) + 1


def lock_released(win: Any, target_world: int, excl: bool) -> None:
    """Before Win_unlock releases: publish this rank's clock to later
    acquirers of the same (window, target)."""
    env = _env()
    if env is None:
        return
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    key = (_win_key(win), int(target_world))
    with tr.lock:
        vc = tr._vc.setdefault(wrank, {})
        vc[wrank] = vc.get(wrank, 0) + 1
        if excl:
            tr._excl_release[key] = dict(vc)
        else:
            _join_into(tr._shared_accum.setdefault(key, {}), vc)


def record_sync(win: Any, op: str) -> None:
    """A window synchronization call (fence/flush/lock) as a ring event —
    context for dumps; no happens-before effect of its own."""
    env = _env()
    if env is None:
        return
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    tr.record(Event("sync", wrank, op=op, win=_win_key(win), file=f, line=ln))


# ---------------------------------------------------------------------------
# Persistent-request records (Start/Wait reordering + R302 front end)
# ---------------------------------------------------------------------------

def buf_id(buf: Any) -> Optional[int]:
    """Stable identity of the array object backing ``buf`` (R302 keys the
    donated-result invalidation window on it)."""
    if buf is None:
        return None
    try:
        from ..buffers import extract_array
        return id(extract_array(buf))
    except Exception:
        return id(buf)


def record_start(comm: Any, op: str, handle: int, rnd: int,
                 invalidates: Optional[int] = None) -> Optional[Event]:
    """A persistent request's Start on this rank. ``invalidates`` names the
    buffer id whose donated-fast-path slot this Start re-donates (the round
    ``rnd - 2`` result) — R302's invalidation edge."""
    env = _env()
    if env is None:
        return None
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    ev = Event("start", wrank, op=op, cid=comm.cid, grp=tuple(comm.group),
               handle=handle, round=rnd, bufid=invalidates, file=f, line=ln)
    return tr.record(ev)


def record_wait(comm: Any, op: str, handle: int, rnd: int,
                result: Any = None) -> Optional[Event]:
    """A persistent request's Wait completing round ``rnd``; ``result`` is
    the object handed back to the user (identity tracked for R302)."""
    env = _env()
    if env is None:
        return None
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    ev = Event("wait", wrank, op=op, cid=comm.cid, grp=tuple(comm.group),
               handle=handle, round=rnd, bufid=buf_id(result),
               file=f, line=ln)
    return tr.record(ev)


# ---------------------------------------------------------------------------
# Fault-tolerance protocol records (T207 front end)
# ---------------------------------------------------------------------------

def record_ft(comm: Any, op: str, epoch: Optional[int] = None,
              survivors: Any = None, dead: Any = None,
              value: Any = None) -> Optional[Event]:
    """One ULFM protocol step (revoke/agree/shrink) with the cross-rank-
    comparable outcome: the agreement epoch, the agreed flag value, and —
    for shrink — the survivor set every rank must derive identically."""
    env = _env()
    if env is None:
        return None
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    extra = {"epoch": epoch}
    if survivors is not None:
        extra["survivors"] = tuple(sorted(survivors))
    if dead is not None:
        extra["dead"] = tuple(sorted(dead))
    if value is not None:
        extra["value"] = value
    ev = Event("ft", wrank, op=op, cid=comm.cid, grp=tuple(comm.group),
               extra=extra, file=f, line=ln)
    return tr.record(ev)


# ---------------------------------------------------------------------------
# Elastic-rebind protocol records (T214 front end)
# ---------------------------------------------------------------------------

def record_elastic(comm: Any, op: str, epoch: Optional[int] = None,
                   declared: Any = None) -> Optional[Event]:
    """One elastic rebind step (``quiesce``/``resume``) as seen from a rank
    thread. ``declared`` is the set of ranks the protocol *intends* to
    rendezvous (normally the comm's group): the T214 check holds every
    declared rank that appears in the trace to having recorded this round.
    The barrier itself is a real traced collective — this event only carries
    the protocol metadata (the explorer models the barrier, not this)."""
    env = _env()
    if env is None:
        return None
    ctx, wrank = env
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    extra = {"epoch": epoch,
             "declared": tuple(sorted(declared if declared is not None
                                      else comm.group))}
    ev = Event("elastic", wrank, op=op, cid=comm.cid, grp=tuple(comm.group),
               extra=extra, file=f, line=ln)
    return tr.record(ev)


# ---------------------------------------------------------------------------
# Serve-tier records (T208 front end + dispatcher-interleaving context).
# The broker's handler/dispatcher threads run without a rank env, so these
# take the pool ctx explicitly and record under the synthetic rank -1.
# ---------------------------------------------------------------------------

BROKER_RANK = -1


def record_serve(ctx: Any, op: str, **extra: Any) -> Optional[Event]:
    """One broker-side event (lease grant/revoke, op dispatch, ledger
    flush) in the pool context's trace, under the synthetic BROKER_RANK."""
    if not enabled() or ctx is None:
        return None
    tr = tracer_for(ctx, create=True)
    f, ln = call_site()
    ev = Event("serve", BROKER_RANK, op=op, cid=extra.pop("cid", None),
               extra=extra or None, file=f, line=ln)
    return tr.record(ev)


# ---------------------------------------------------------------------------
# Trace persistence: one JSON file per rank (the multi-process tier has one
# Tracer per process), merged back by load_trace for offline exploration.
# ---------------------------------------------------------------------------

_DUMP_FIELDS = ("kind", "rank", "op", "cid", "seq", "peer", "root", "tag",
                "count", "dtype", "grp", "algo", "file", "line", "t",
                "want", "wtag", "handle", "round", "bufid", "extra")


def _jsonable(v: Any) -> Any:
    if isinstance(v, tuple):
        return list(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def dump_trace(tr: "Tracer", path: str, rank: Optional[int] = None) -> str:
    """Write ``tr``'s events (one rank, or every ring this process holds)
    as JSON to ``path``. Returns the path written."""
    import json
    with tr.lock:
        ranks = [rank] if rank is not None else sorted(tr.rings)
        recs = []
        for r in ranks:
            for ev in tr.rings.get(r, ()):
                recs.append({k: _jsonable(getattr(ev, k, None))
                             for k in _DUMP_FIELDS})
        payload = {
            "version": 1,
            "nprocs": tr.nprocs,
            "dropped": {str(k): v for k, v in tr.dropped.items()},
            "events": recs,
        }
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def finalize_dump() -> None:
    """Called from MPI.Finalize: when ``trace_dump`` names a path prefix,
    write this rank's trace to ``<prefix>.rank<N>.trace.json``."""
    if not enabled():
        return
    cfg = config.load()
    prefix = getattr(cfg, "trace_dump", "")
    if not prefix:
        return
    env = _env()
    if env is None:
        return
    ctx, wrank = env
    tr = tracer_for(ctx)
    if tr is None:
        return
    dump_trace(tr, f"{prefix}.rank{wrank}.trace.json", rank=wrank)


def load_trace(paths: Any) -> Tracer:
    """Merge one or more trace-dump JSON files (or a prefix produced by
    ``finalize_dump``) back into an offline :class:`Tracer`."""
    import glob
    import json
    if isinstance(paths, str):
        paths = [paths]
    files: list = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            files.extend(sorted(glob.glob(f"{p}.rank*.trace.json")))
    if not files:
        raise FileNotFoundError(f"no trace dumps found for {paths!r}")
    events = []
    nprocs = 0
    dropped: Dict[int, int] = {}
    for fn in files:
        with open(fn) as f:
            payload = json.load(f)
        nprocs = max(nprocs, int(payload.get("nprocs", 0)))
        for r, n in payload.get("dropped", {}).items():
            dropped[int(r)] = dropped.get(int(r), 0) + int(n)
        events.extend(payload.get("events", ()))
    tr = Tracer(nprocs, max(len(events), 16))
    tr.dropped = dropped
    for rec in sorted(events, key=lambda e: (e.get("t") or 0.0)):
        kw = {k: rec.get(k) for k in _DUMP_FIELDS if k not in ("kind", "rank")}
        if isinstance(kw.get("grp"), list):
            kw["grp"] = tuple(kw["grp"])
        if isinstance(kw.get("tag"), list):
            kw["tag"] = tuple(kw["tag"])
        seq = kw.pop("seq", None)
        ev = Event(rec["kind"], int(rec["rank"]), **kw)
        tr.record(ev)
        if seq is not None:
            ev.seq = seq     # preserve the recorder's absolute ordinal
    return tr
