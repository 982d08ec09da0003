"""Request-scoped trace context: the distributed-tracing spine of the serve
tier (docs/observability.md "Request traces").

A :class:`TraceCtx` is three fields — a 64-bit ``trace_id``, the parent
``span_id``, and the sampling bit — minted in ``serve/session.py`` when a
sampled op starts, carried across every hop in the frame metadata
(``meta["trace"] = {"id", "span", "s"}``), and bound to a thread-local slot
on the serving side so the front-door worker, the fair-queue dispatcher, and
the per-rank pvar op-scope can each open child spans without plumbing an
argument through every call signature.

Spans land in one process-global bounded buffer as plain dicts::

    {"trace": id, "span": sid, "parent": psid, "name": "...",
     "who": "client" | "router" | "broker" | "rank 3" | ...,
     "t0": perf_counter, "t1": perf_counter, "status": "ok" | "error", ...}

``analyze/timeline.py`` renders the buffer as Chrome-trace slices (one lane
per ``who``); multi-process runs dump per process via :func:`dump_spans`
and merge offline.

Overhead discipline matches ``analyze/events.enabled()``: an unsampled run
pays one tuple compare against ``config.GENERATION`` per op — no id
minting, no TLS writes, no metadata key.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import config
from . import locksmith

_UNSET = object()
_rate_cache: Tuple[Any, float] = (_UNSET, 0.0)


def sample_rate() -> float:
    """The effective TPU_MPI_TRACE_SAMPLE rate — cached on
    ``config.GENERATION`` so the untraced hot path is one tuple compare."""
    global _rate_cache
    cached_gen, val = _rate_cache
    if cached_gen == config.GENERATION:
        return val
    val = float(config.load().trace_sample)
    _rate_cache = (config.GENERATION, val)
    return val


def enabled() -> bool:
    """Whether request tracing can sample at all (rate > 0)."""
    return sample_rate() > 0.0


def sample() -> bool:
    """One sampling decision at trace-birth time (client session op)."""
    rate = sample_rate()
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return random.random() < rate


# span-id minting: a per-process nonce + counter keeps ids unique across
# the processes one trace crosses without coordination.
_NONCE = os.urandom(3).hex()
_ids = itertools.count(1)


def _new_id() -> str:
    return f"{_NONCE}-{next(_ids)}"


class TraceCtx:
    """One request's position in its trace: where a child span attaches."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    @classmethod
    def mint(cls) -> "TraceCtx":
        """A fresh root context (trace birth, client side)."""
        return cls(os.urandom(8).hex(), _new_id(), True)

    def child(self) -> "TraceCtx":
        """A context one span deeper (the receiver side of a hop)."""
        return TraceCtx(self.trace_id, _new_id(), self.sampled)

    def to_meta(self) -> dict:
        """The compact frame-metadata carriage of this context."""
        return {"id": self.trace_id, "span": self.span_id,
                "s": 1 if self.sampled else 0}

    @classmethod
    def from_meta(cls, meta: Optional[dict]) -> Optional["TraceCtx"]:
        """Recover a context from frame metadata (None when untraced)."""
        t = (meta or {}).get("trace")
        if not isinstance(t, dict) or "id" not in t or "span" not in t:
            return None
        return cls(str(t["id"]), str(t["span"]), bool(t.get("s", 1)))

    def __repr__(self) -> str:
        return f"<TraceCtx {self.trace_id}/{self.span_id}>"


# ---------------------------------------------------------------------------
# Thread-local binding: the serving side's implicit context slot.
# ---------------------------------------------------------------------------

_tls = threading.local()


def current() -> Optional[TraceCtx]:
    """The TraceCtx bound to this thread (None when untraced)."""
    return getattr(_tls, "ctx", None)


class bind:
    """Context manager binding ``ctx`` (may be None) to this thread."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceCtx]):
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceCtx]:
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> bool:
        _tls.ctx = self._prev
        return False


# ---------------------------------------------------------------------------
# Span buffer: process-global, bounded, drained by timeline export.
# ---------------------------------------------------------------------------

_SPAN_CAP = 8192
_spans_lock = locksmith.make_lock("tracectx.spans")
_spans: List[dict] = []
_spans_dropped = 0


def start_span(ctx: Optional[TraceCtx], name: str, who: str,
               **extra: Any) -> Optional[dict]:
    """Open a child span under ``ctx``; returns the record to pass to
    :func:`end_span`, or None when ``ctx`` is absent/unsampled. The record
    is NOT in the buffer until ended — an abandoned record costs nothing."""
    if ctx is None or not ctx.sampled:
        return None
    rec = {"trace": ctx.trace_id, "span": _new_id(), "parent": ctx.span_id,
           "name": name, "who": who, "t0": time.perf_counter(), "t1": None,
           "status": "ok"}
    if extra:
        rec.update({k: v for k, v in extra.items() if v is not None})
    return rec


def start_root(name: str, who: str, **extra: Any):
    """Trace birth: one sampling decision, a fresh trace id, and the OPEN
    root span record. Returns ``(ctx, rec)`` — ``ctx.span_id`` is the root
    span itself, so downstream hops parent directly under it — or
    ``(None, None)`` when this request is not sampled."""
    if not sample():
        return None, None
    trace_id = os.urandom(8).hex()
    rec = {"trace": trace_id, "span": _new_id(), "parent": None,
           "name": name, "who": who, "t0": time.perf_counter(), "t1": None,
           "status": "ok"}
    if extra:
        rec.update({k: v for k, v in extra.items() if v is not None})
    return TraceCtx(trace_id, rec["span"], True), rec


def end_span(rec: Optional[dict], status: str = "ok", **extra: Any) -> None:
    """Close and publish a span opened by :func:`start_span`."""
    if rec is None:
        return
    rec["t1"] = time.perf_counter()
    rec["status"] = status
    if extra:
        rec.update(extra)
    global _spans_dropped
    with _spans_lock:
        if len(_spans) >= _SPAN_CAP:
            del _spans[:_SPAN_CAP // 4]          # drop the oldest quarter
            _spans_dropped += _SPAN_CAP // 4
        _spans.append(rec)


def emit_span(ctx: Optional[TraceCtx], name: str, who: str, t0: float,
              t1: float, status: str = "ok", **extra: Any) -> Optional[dict]:
    """Publish a span whose bracket was measured elsewhere (a queue wait
    reconstructed at pop time, a pvar op scope's phase spans). Returns the
    published record so callers can parent further children under it."""
    if ctx is None or not ctx.sampled:
        return None
    rec = {"trace": ctx.trace_id, "span": _new_id(), "parent": ctx.span_id,
           "name": name, "who": who, "t0": t0, "t1": t1, "status": status}
    if extra:
        rec.update(extra)
    global _spans_dropped
    with _spans_lock:
        if len(_spans) >= _SPAN_CAP:
            del _spans[:_SPAN_CAP // 4]
            _spans_dropped += _SPAN_CAP // 4
        _spans.append(rec)
    return rec


class span:
    """``with span(ctx, name, who): ...`` — the two calls above as a scope;
    an exception closes the span with error status (and propagates)."""

    __slots__ = ("_rec", "_args", "_kw")

    def __init__(self, ctx: Optional[TraceCtx], name: str, who: str,
                 **extra: Any):
        self._args = (ctx, name, who)
        self._kw = extra

    def __enter__(self) -> Optional[dict]:
        self._rec = start_span(*self._args, **self._kw)
        return self._rec

    def __exit__(self, et, ev, tb) -> bool:
        if et is None:
            end_span(self._rec)
        else:
            end_span(self._rec, status="error", error=type(ev).__name__)
        return False


def child_for_span(rec: Optional[dict],
                   ctx: Optional[TraceCtx]) -> Optional[TraceCtx]:
    """A TraceCtx whose children parent under an OPEN span record — how a
    hop makes its downstream work nest inside its own span."""
    if rec is None or ctx is None:
        return ctx
    return TraceCtx(rec["trace"], rec["span"], True)


def drain(trace_id: Optional[str] = None) -> List[dict]:
    """Snapshot (without clearing) the span buffer, optionally filtered to
    one trace. Single-process cpu-sim runs read their whole trace here."""
    with _spans_lock:
        out = list(_spans)
    if trace_id is not None:
        out = [s for s in out if s["trace"] == trace_id]
    return out


def reset() -> None:
    """Clear the buffer (test isolation)."""
    global _spans_dropped
    with _spans_lock:
        _spans.clear()
        _spans_dropped = 0


def dump_spans(path: str) -> str:
    """Write this process's span buffer as JSON; merge offline with
    :func:`load_spans` over several files."""
    with _spans_lock:
        payload = {"version": 1, "pid": os.getpid(),
                   "dropped": _spans_dropped, "spans": list(_spans)}
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def load_spans(paths: Any) -> List[dict]:
    """Merge one or more span-dump files back into one span list."""
    if isinstance(paths, str):
        paths = [paths]
    out: List[dict] = []
    for p in paths:
        with open(p) as f:
            payload = json.load(f)
        out.extend(payload.get("spans", ()))
    return out
