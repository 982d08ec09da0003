"""Crash flight recorder: what the process was doing right before it died
(docs/observability.md "Flight recorder").

An always-on bounded ring of recent lifecycle notes — op dispatches, lease
grants/revocations, typed errors, failure-detector verdicts — kept cheap
enough to leave enabled in production: :func:`note` on the disabled path is
one generation-gated tuple compare (the ``analyze/events.enabled()``
discipline), and on the enabled path a lock-free slot write (one fixed list,
a monotonically increasing index modulo capacity; each slot store is atomic
under the GIL, so writers never take a lock and a torn snapshot can at worst
show one stale slot).

The ring auto-dumps to a CRC-stamped JSON file when the process hits a
fatal event: ProcFailedError / RevokedError / DeadlockError construction
(hooked in ``error.py``), a failure-detector death verdict
(``_runtime.FailureDetector``), a broker lease revocation, or SIGTERM
(:func:`install_signal_hook`). ``python -m tpu_mpi_torch.analyze flight <dump>``
verifies the CRC and renders the timeline.

Knobs: ``TPU_MPI_FLIGHT_RING`` (capacity; 0 disables recorder and hooks),
``TPU_MPI_FLIGHT_DIR`` (dump directory, default the system temp dir).
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from . import config

_UNSET = object()
# (generation, capacity) — capacity 0 means disabled
_cap_cache: Tuple[Any, int] = (_UNSET, 0)


def _capacity() -> int:
    """The effective ring capacity, cached on ``config.GENERATION``.

    Reads ``config._cached`` directly instead of ``config.load()``: the
    error-raise hook can fire from *inside* a ``load()`` (a malformed knob
    raising under the config lock), and a recursive ``load()`` there would
    self-deadlock. Before the first successful load the recorder simply
    reports disabled."""
    global _cap_cache
    cached_gen, cap = _cap_cache
    if cached_gen == config.GENERATION:
        return cap
    cfg = config._cached
    if cfg is None:
        return 0                      # config not loaded yet; don't cache
    cap = max(0, int(cfg.flight_ring))
    _cap_cache = (config.GENERATION, cap)
    return cap


def enabled() -> bool:
    """Whether the recorder is armed (ring capacity > 0)."""
    return _capacity() > 0


class _Ring:
    """Lock-free bounded record store: one fixed slot list, writers claim
    slots through an atomic counter. A reader's snapshot may interleave
    with writers — acceptable for a post-mortem artifact."""

    __slots__ = ("cap", "slots", "_next")

    def __init__(self, cap: int):
        self.cap = cap
        self.slots: List[Optional[dict]] = [None] * cap
        self._next = itertools.count()

    def append(self, rec: dict) -> None:
        i = next(self._next)
        rec["i"] = i
        self.slots[i % self.cap] = rec

    def snapshot(self) -> List[dict]:
        recs = [r for r in self.slots if r is not None]
        recs.sort(key=lambda r: r["i"])
        return recs


_ring: Optional[_Ring] = None
_ring_gate = threading.Lock()      # ring construction only, never on append


def _get_ring() -> Optional[_Ring]:
    cap = _capacity()
    if cap <= 0:
        return None
    global _ring
    r = _ring
    if r is not None and r.cap == cap:
        return r
    with _ring_gate:
        if _ring is None or _ring.cap != cap:
            _ring = _Ring(cap)
        return _ring


def note(kind: str, **fields: Any) -> None:
    """Record one lifecycle note. Disabled path: one tuple compare."""
    if _capacity() <= 0:
        return
    ring = _get_ring()
    if ring is None:
        return
    rec: Dict[str, Any] = {"t": time.time(), "mono": time.monotonic(),
                           "kind": kind,
                           "thread": threading.current_thread().name}
    for k, v in fields.items():
        if v is not None:
            rec[k] = v if isinstance(v, (str, int, float, bool)) else repr(v)
    ring.append(rec)


def note_span(rec: dict) -> None:
    """Mirror a closed trace span into the ring (the recorder's view of
    recent request activity; called by tracectx consumers, sampled path)."""
    note("span", name=rec.get("name"), who=rec.get("who"),
         trace=rec.get("trace"), status=rec.get("status"),
         dur_us=int(((rec.get("t1") or 0) - (rec.get("t0") or 0)) * 1e6))


# ---------------------------------------------------------------------------
# Error hook (called lazily from tpu_mpi_torch.error.MPIError.__init__)
# ---------------------------------------------------------------------------

# error codes whose construction is a crash-grade event worth a dump
_FATAL_CODES = frozenset((64, 69, 70))   # DEADLOCK, PROC_FAILED, REVOKED


def on_error(exc: BaseException) -> None:
    """Every typed MPIError lands a note; crash-grade codes auto-dump."""
    if _capacity() <= 0:
        return
    code = int(getattr(exc, "code", 0) or 0)
    note("error", type=type(exc).__name__, code=code,
         message=str(exc.args[0]) if exc.args else str(exc))
    if code in _FATAL_CODES:
        auto_dump(f"error-{type(exc).__name__}")


# ---------------------------------------------------------------------------
# Auto-dump: CRC-stamped JSON, rate-limited per reason.
# ---------------------------------------------------------------------------

_dump_lock = threading.Lock()
_last_dump: Dict[str, float] = {}
_DUMP_MIN_INTERVAL_S = 2.0


def dump_path(reason: str) -> str:
    import tempfile
    cfg = config._cached
    d = (cfg.flight_dir if cfg is not None else "") or tempfile.gettempdir()
    safe = "".join(c if c.isalnum() or c in "-_." else "-" for c in reason)
    return os.path.join(d, f"flight-{os.getpid()}-{safe}.json")


def dump(path: str, reason: str = "manual") -> str:
    """Write the ring to ``path`` with a CRC32 stamp over the event body."""
    ring = _get_ring()
    events = ring.snapshot() if ring is not None else []
    body = json.dumps(events, separators=(",", ":"), sort_keys=True)
    payload = {"version": 1, "pid": os.getpid(), "reason": reason,
               "t": time.time(), "crc32": zlib.crc32(body.encode()),
               "events": events}
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def auto_dump(reason: str) -> Optional[str]:
    """Dump on a fatal event — best-effort (a dump failure must never mask
    the error being raised) and rate-limited per reason."""
    if _capacity() <= 0:
        return None
    now = time.monotonic()
    with _dump_lock:
        last = _last_dump.get(reason, -1e9)
        if now - last < _DUMP_MIN_INTERVAL_S:
            return None
        _last_dump[reason] = now
    try:
        return dump(dump_path(reason), reason)
    except OSError:
        return None


def read_dump(path: str) -> dict:
    """Load and CRC-verify a flight dump; raises ValueError on corruption."""
    with open(path) as f:
        payload = json.load(f)
    events = payload.get("events", [])
    body = json.dumps(events, separators=(",", ":"), sort_keys=True)
    crc = zlib.crc32(body.encode())
    if crc != payload.get("crc32"):
        raise ValueError(f"flight dump {path!r} failed its CRC check "
                         f"(stored {payload.get('crc32')}, computed {crc})")
    return payload


def render(payload: dict) -> str:
    """Human-readable timeline of a verified dump (the CLI's output)."""
    lines = [f"flight recorder dump — pid {payload.get('pid')} "
             f"reason {payload.get('reason')!r} "
             f"at {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(payload.get('t', 0)))}"]
    events = payload.get("events", [])
    if not events:
        lines.append("  (ring empty)")
        return "\n".join(lines)
    t0 = events[0].get("mono", 0.0)
    for rec in events:
        dt = (rec.get("mono", t0) - t0) * 1e3
        core = {k: v for k, v in rec.items()
                if k not in ("t", "mono", "kind", "i", "thread")}
        detail = " ".join(f"{k}={v}" for k, v in core.items())
        lines.append(f"  +{dt:10.3f} ms  [{rec.get('thread', '?')}] "
                     f"{rec.get('kind', '?'):<12} {detail}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# SIGTERM hook: install explicitly (launcher / broker main), never at import.
# ---------------------------------------------------------------------------

_prev_sigterm: Any = None
_hook_installed = False


def _on_sigterm(signum, frame):
    note("sigterm")
    auto_dump("sigterm")
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    else:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def install_signal_hook() -> bool:
    """Chain a SIGTERM handler that dumps the ring before the previous
    disposition runs. Main-thread only (signal module contract); returns
    whether the hook is installed."""
    global _prev_sigterm, _hook_installed
    if _hook_installed or not enabled():
        return _hook_installed
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        return False
    _hook_installed = True
    return True


def reset() -> None:
    """Drop the ring and dump rate-limits (test isolation)."""
    global _ring, _cap_cache
    with _ring_gate:
        _ring = None
        _cap_cache = (_UNSET, 0)
    with _dump_lock:
        _last_dump.clear()
