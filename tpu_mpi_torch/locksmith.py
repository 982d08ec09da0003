"""Runtime lock witness — the dynamic half of the concurrency analyzer.

The serve fabric (broker dispatch, procs-pool driver, elastic rebind,
infer scheduler, router splice threads) is a hand-rolled thread fabric;
``tpu_mpi_torch.analyze.concurrency`` audits it statically, and this module
audits it live. With ``TPU_MPI_LOCKCHECK=1`` every named lock
construction site (:func:`make_lock` / :func:`make_rlock` /
:func:`make_condition`) returns a witness shim instead of the plain
``threading`` primitive. The witness

- records which locks each thread holds and where it acquired them,
- maintains the process-global acquisition-order graph, and raises a
  typed :class:`tpu_mpi_torch.error.LockOrderError` the moment two threads
  establish *inverted* order — no thread has to actually deadlock,
- records **C401** (held-while-blocking) when a witnessed
  ``Condition.wait`` runs while the thread holds another witnessed lock,
- feeds the ``locks`` pvar block (``acquires`` / ``contended`` /
  ``max_held_ns`` per named lock — ``tpurun --stats``), and
- lands acquisition events for dispatch-named locks in the event IR
  (once :func:`bind_context` attaches a tracer) so ``analyze verify``
  can audit dispatch-section serialization (T215).

Pay-for-use like pvars: the gate is evaluated once, at lock
*construction* — with the knob off every factory returns the plain
``threading`` primitive and the steady-state cost is zero.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from . import config
from .error import LockOrderError

_UNSET = object()
_enabled_cache: Tuple[Any, bool] = (_UNSET, False)
_stacks_cache: Tuple[Any, bool] = (_UNSET, False)


def enabled() -> bool:
    """Whether the witness is armed — cached on ``config.GENERATION`` so
    the per-construction cost of a disabled run is one tuple compare."""
    global _enabled_cache
    cached_gen, val = _enabled_cache
    if cached_gen == config.GENERATION:
        return val
    val = bool(config.load().lockcheck)
    _enabled_cache = (config.GENERATION, val)
    return val


def _stacks() -> bool:
    global _stacks_cache
    cached_gen, val = _stacks_cache
    if cached_gen == config.GENERATION:
        return val
    val = bool(config.load().lockcheck_stacks)
    _stacks_cache = (config.GENERATION, val)
    return val


# ---------------------------------------------------------------------------
# Witness state: held-lock registry (per thread, globally visible so the
# deadlock dump can render every thread), order graph with per-edge
# provenance, and the C401 record list.
# ---------------------------------------------------------------------------

_reg_lock = threading.Lock()
# thread ident -> (thread name, [ [witness, site, t_ns, count], ... ])
_held_by_thread: Dict[int, Tuple[str, list]] = {}
# order graph: name -> set of names acquired while `name` was held
_succ: Dict[str, set] = {}
# edge (outer, inner) -> (outer's acquisition site, inner's acquisition site)
# — the first observation's provenance, rendered into cycle reports
_edge_sites: Dict[Tuple[str, str], Tuple[str, str]] = {}
# C401 diagnostics (analyze.diagnostics.Diagnostic records)
_c401: List[Any] = []
# bound tracer context for event-IR recording (see bind_context)
_ctx: Any = None


def _site() -> str:
    """The acquisition site as a ``file:line`` chain — the caller's frame
    outside this module, or the full stack under TPU_MPI_LOCKCHECK_STACKS."""
    if _stacks():
        frames = traceback.extract_stack()[:-2]
        return " <- ".join(f"{f.filename}:{f.lineno}"
                           for f in reversed(frames[-8:]))
    f = sys._getframe(1)
    here = __file__
    while f is not None and f.f_code.co_filename == here:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _held_entries() -> list:
    """This thread's held-lock entry list (created on first use)."""
    ident = threading.get_ident()
    with _reg_lock:
        row = _held_by_thread.get(ident)
        if row is None:
            row = _held_by_thread[ident] = (threading.current_thread().name,
                                            [])
        return row[1]


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """A lock-name path ``src -> ... -> dst`` in the order graph, or None."""
    if src == dst:
        return [src]
    seen = {src}
    parent: Dict[str, str] = {}
    frontier = [src]
    while frontier:
        nxt = []
        for a in frontier:
            for b in _succ.get(a, ()):
                if b in seen:
                    continue
                seen.add(b)
                parent[b] = a
                if b == dst:
                    path = [b]
                    while path[-1] != src:
                        path.append(parent[path[-1]])
                    path.reverse()
                    return path
                nxt.append(b)
        frontier = nxt
    return None


def _render_chain(path: List[str]) -> str:
    hops = []
    for a, b in zip(path, path[1:]):
        outer, inner = _edge_sites.get((a, b), ("<unknown>", "<unknown>"))
        hops.append(f"{a} (held from {outer}) -> {b} (acquired at {inner})")
    return "; ".join(hops)


def _check_order(inner: "_WitnessBase", inner_site: str, held: list) -> None:
    """Called with ``_reg_lock`` held, before blocking on ``inner``: add
    edges held-lock -> inner and raise LockOrderError on any inversion."""
    for entry in held:
        outer = entry[0]
        if outer is inner:
            continue
        a, b = outer.name, inner.name
        if b in _succ.get(a, ()):
            continue                      # edge already established
        back = _find_path(b, a)
        if back is not None:
            # provenance of the forward edge is THIS acquisition
            forward = f"{a} (held from {entry[1]}) -> " \
                      f"{b} (acquired at {inner_site})"
            raise LockOrderError(
                f"lock order inversion: acquiring {b!r} while holding "
                f"{a!r}, but the opposite order is already established\n"
                f"  this thread:        {forward}\n"
                f"  established order:  {_render_chain(back)}")
        _succ.setdefault(a, set()).add(b)
        _edge_sites[(a, b)] = (entry[1], inner_site)


def _record_event(name: str, op: str) -> None:
    """Land a witness event in the event IR when a tracer is bound and the
    lock is dispatch-named (the T215-relevant critical sections)."""
    if _ctx is None or "dispatch" not in name:
        return
    try:
        from .analyze import events as _ev
        _ev.record_serve(_ctx, op, lock=name)
    except Exception:
        pass


class _WitnessBase:
    """Shared acquire/release bookkeeping for Lock and RLock witnesses."""

    reentrant = False

    def __init__(self, name: str, inner):
        self.name = str(name)
        self._inner = inner

    # -- context manager ----------------------------------------------------
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        site = _site()
        held = _held_entries()
        with _reg_lock:
            mine = None
            if self.reentrant:
                for entry in held:
                    if entry[0] is self:
                        mine = entry
                        break
            if mine is None:
                _check_order(self, site, held)
        if mine is not None:
            # reentrant re-acquire: no order edges, no contention stats
            got = self._inner.acquire(blocking, timeout)
            if got:
                with _reg_lock:
                    mine[3] += 1
            return got
        contended = 0
        got = self._inner.acquire(False)
        if not got:
            contended = 1
            if not blocking:
                _note(self.name, acquires=0, contended=1)
                return False
            got = self._inner.acquire(True, timeout)
            if not got:
                _note(self.name, acquires=0, contended=1)
                return False
        t = time.monotonic_ns()
        with _reg_lock:
            held.append([self, site, t, 1])
        _note(self.name, acquires=1, contended=contended)
        _record_event(self.name, "lock_acquire")
        return True

    def release(self) -> None:
        held = _held_entries()
        held_ns = 0
        with _reg_lock:
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is self:
                    held[i][3] -= 1
                    if held[i][3] == 0:
                        held_ns = time.monotonic_ns() - held[i][2]
                        del held[i]
                    break
            # a plain Lock may legally be released by a thread that never
            # acquired it (handoff); the witness just loses the hold time
        self._inner.release()
        if held_ns:
            _note(self.name, held_ns=held_ns)
            _record_event(self.name, "lock_release")


class LockWitness(_WitnessBase):
    """``threading.Lock`` shim with order-graph witnessing."""

    def __init__(self, name: str, inner=None):
        super().__init__(name, inner if inner is not None
                         else threading.Lock())


class RLockWitness(_WitnessBase):
    """``threading.RLock`` shim — reentrant acquires add no order edges."""

    reentrant = True

    def __init__(self, name: str, inner=None):
        super().__init__(name, inner if inner is not None
                         else threading.RLock())


class ConditionWitness:
    """``threading.Condition`` shim over a witnessed lock. ``wait`` drops
    the witness's held entry for the duration (the underlying condition
    releases the real lock) and records C401 when the waiting thread still
    holds *other* witnessed locks — that is held-while-blocking, the
    runtime twin of the static L113."""

    def __init__(self, name: str, lock: Optional[_WitnessBase] = None):
        self.name = str(name)
        self._wit = lock if lock is not None else LockWitness(name)
        self._cond = threading.Condition(self._wit._inner)

    # -- lock surface (delegates to the witness) ----------------------------
    def __enter__(self):
        self._wit.acquire()
        return self

    def __exit__(self, *exc):
        self._wit.release()
        return False

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._wit.acquire(blocking, timeout)

    def release(self) -> None:
        self._wit.release()

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        held = _held_entries()
        saved = None
        with _reg_lock:
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is self._wit:
                    saved = held.pop(i)
                    break
            others = [e for e in held if e[0] is not self._wit]
            if others:
                _note_c401(self.name, others)
        try:
            return self._cond.wait(timeout)
        finally:
            if saved is not None:
                saved[2] = time.monotonic_ns()   # hold restarts at wake
                with _reg_lock:
                    held.append(saved)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # CPython's Condition.wait_for, routed through our wait()
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result


def _note(name: str, **counts: int) -> None:
    from . import perfvars
    perfvars.note_lock(name, **counts)


def _note_c401(cond_name: str, others: list) -> None:
    """Record one held-while-blocking observation (called with _reg_lock)."""
    from .analyze.diagnostics import Diagnostic
    site = _site()
    file, _, line = site.partition(" <- ")[0].rpartition(":")
    try:
        lineno = int(line)
    except ValueError:
        file, lineno = site, 0
    names = ", ".join(sorted({e[0].name for e in others}))
    _c401.append(Diagnostic(
        "C401",
        f"Condition {cond_name!r} waited while this thread held "
        f"{names}",
        file=file or "<unknown>", line=lineno,
        related=tuple(_entry_related(e) for e in others)))


def _entry_related(entry) -> tuple:
    site = entry[1].partition(" <- ")[0]
    file, _, line = site.rpartition(":")
    try:
        lineno = int(line)
    except ValueError:
        file, lineno = site, 0
    return (file or "<unknown>", lineno, f"holding {entry[0].name!r}")


# ---------------------------------------------------------------------------
# Factories — the ONLY gate. With lockcheck off these return the plain
# threading primitives; nothing else in this module runs.
# ---------------------------------------------------------------------------

def make_lock(name: str):
    """A named mutex: ``threading.Lock()`` normally, a witness when armed."""
    if not enabled():
        return threading.Lock()
    return LockWitness(name)


def make_rlock(name: str):
    """A named reentrant mutex (see :func:`make_lock`)."""
    if not enabled():
        return threading.RLock()
    return RLockWitness(name)


def make_condition(name: str, lock=None):
    """A named condition variable over ``lock`` (or a fresh mutex). Pairs
    with locks from :func:`make_lock` / :func:`make_rlock`: hand the same
    object in and wait/notify share the witness's bookkeeping."""
    if isinstance(lock, _WitnessBase):
        return ConditionWitness(name, lock)
    if not enabled():
        return threading.Condition(lock)
    if lock is not None:
        # a plain lock constructed before the knob flipped: stay plain —
        # witnessing only the condition would corrupt held bookkeeping
        return threading.Condition(lock)
    return ConditionWitness(name)


# ---------------------------------------------------------------------------
# Introspection: dumps for DeadlockError / analyze verify / tests.
# ---------------------------------------------------------------------------

def bind_context(ctx) -> None:
    """Attach a tracer context: dispatch-named lock transitions land in the
    event IR from here on (kind ``serve``, ops ``lock_acquire`` /
    ``lock_release``)."""
    global _ctx
    _ctx = ctx


def armed() -> bool:
    """Whether any witness state exists (locks were built while enabled)."""
    with _reg_lock:
        return bool(_succ or _held_by_thread or _c401)


def c401_diagnostics() -> list:
    """C401 held-while-blocking observations so far (Diagnostic records)."""
    with _reg_lock:
        return list(_c401)


def order_graph() -> Dict[str, tuple]:
    """The observed acquisition-order graph as ``{outer: (inner, ...)}``."""
    with _reg_lock:
        return {a: tuple(sorted(bs)) for a, bs in sorted(_succ.items())}


def witness_report() -> str:
    """Per-thread held-lock sets with acquisition sites — appended to
    deadlock dumps when the witness is armed. Empty string when idle."""
    with _reg_lock:
        rows = []
        for ident, (tname, held) in sorted(_held_by_thread.items()):
            if not held:
                continue
            rows.append(f"  thread {tname!r} ({ident}):")
            for wit, site, _t, count in held:
                times = f" x{count}" if count > 1 else ""
                rows.append(f"    holds {wit.name!r}{times} "
                            f"acquired at {site}")
        if not rows:
            return ""
        return "witness-held locks per thread:\n" + "\n".join(rows)


def reset() -> None:
    """Drop all witness state (tests only — live witnesses keep working,
    their next acquisitions rebuild the graph)."""
    global _ctx
    with _reg_lock:
        _held_by_thread.clear()
        _succ.clear()
        _edge_sites.clear()
        _c401.clear()
    _ctx = None
