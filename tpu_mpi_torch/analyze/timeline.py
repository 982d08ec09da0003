"""Cross-rank Chrome-trace / Perfetto export of the event IR.

The pvar subsystem (:mod:`tpu_mpi_torch.perfvars`) stamps traced events with
``t_start``/``t_end`` and the phase spans the channels observed
(rendezvous / fold / copy). This module turns those into the Chrome
trace-event JSON format (load in Perfetto UI or ``chrome://tracing``):
one process row per rank (``pid`` = world rank), the whole op as a
complete-event slice, its phases as nested slices, and point events
(sends, receives, RMA accesses) as instants.

Ranks on the multi-process tier each run their own ``perf_counter``
clock, so a naive merge skews rows by process start time. :func:`clock_offsets` fixes
that with the classic Barrier-exchange estimate: every rank samples its
clock immediately after leaving a Barrier (all ranks exit within one
rendezvous wakeup of each other), Allgathers the samples, and the median
per-rank delta over several rounds becomes the rank's offset to rank 0's
clock. Subtracting a constant per rank keeps per-rank timestamp order
monotone by construction.

Typical use (every rank calls; rank 0 writes)::

    MPI.analyze.timeline.merge_trace(comm, "trace.json")
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

# Chrome-trace envelope version stamped in otherData. 2 added thread_name
# metadata rows, named the synthetic broker lane, and the request-span
# renderer (spans_to_chrome).
SCHEMA = 2


def clock_offsets(comm: Any, rounds: int = 5) -> List[float]:
    """Per-comm-rank clock offsets to rank 0 (collective: all ranks call).

    ``aligned_t = t - offsets[rank]`` puts every rank's ``time.perf_counter``
    readings on rank 0's clock, up to the Barrier-exit skew (microseconds
    on one host). The median over ``rounds`` rounds rejects stragglers
    (a rank descheduled between Barrier exit and its clock sample)."""
    import numpy as np

    from ..collective import Allgather, Barrier
    size = comm.size()
    samples = np.empty((rounds, size), dtype=np.float64)
    mine = np.empty(1, dtype=np.float64)
    for i in range(rounds):
        Barrier(comm)
        mine[0] = time.perf_counter()
        samples[i] = np.asarray(Allgather(mine, comm)).reshape(-1)
    deltas = samples - samples[:, :1]          # per-round offset to rank 0
    return [float(x) for x in np.median(deltas, axis=0)]


def _event_dicts(events: Sequence[Any]) -> List[dict]:
    """Plain-dict projection of Event records (what travels over the wire
    in merge_trace, and what to_chrome consumes)."""
    out = []
    for ev in events:
        out.append({
            "kind": ev.kind, "rank": ev.rank, "op": ev.op, "cid": ev.cid,
            "seq": ev.seq, "peer": ev.peer, "tag": ev.tag,
            "count": ev.count, "dtype": ev.dtype, "algo": ev.algo,
            "t": ev.t, "t_start": getattr(ev, "t_start", None),
            "t_end": getattr(ev, "t_end", None),
            "phases": getattr(ev, "phases", None),
        })
    return out


def local_events(ctx: Any = None) -> List[dict]:
    """This process's recorded events as plain dicts (proc tier: only the
    local rank; thread tier: every rank shares one tracer)."""
    from . import events as _ev
    if ctx is None:
        from .._runtime import current_env
        env = current_env()
        tr = _ev.tracer_for(env[0]) if env is not None else _ev.last_trace()
    else:
        tr = _ev.tracer_for(ctx)
    if tr is None:
        return []
    return _event_dicts(tr.events())


# the lane of span-ring records taken outside every rank (rank -1 there)
OUTSIDE_RANKS = -2


def to_chrome(event_dicts: Sequence[dict],
              offsets: Optional[Dict[int, float]] = None,
              ring: Sequence[Any] = ()) -> dict:
    """Chrome trace-event JSON object from event dicts and span-ring
    records (``perfvars.take_spans``).

    ``offsets`` maps world rank -> clock offset (seconds, subtracted from
    that rank's timestamps). Spanned events (t_start/t_end) become ph="X"
    complete slices with their phases nested inside; point events become
    ph="i" instants at ``t``; ring records become ph="X" slices on their
    rank's row, one thread a ``tid``, with their CPU time (where read) in
    ``args``. Timestamps are microseconds from the earliest aligned
    instant in the batch."""
    offsets = offsets or {}
    ring = [(r.rank if r.rank >= 0 else OUTSIDE_RANKS, r) for r in ring]
    starts = [(d["rank"], d["t_start"] if d["t_start"] is not None else d["t"])
              for d in event_dicts]
    starts += [(pid, r.t0_ns / 1e9) for pid, r in ring]
    base = min((t - offsets.get(rank, 0.0) for rank, t in starts if t is not None),
               default=0.0)

    def us(t: float, rank: int) -> float:
        return round((t - offsets.get(rank, 0.0) - base) * 1e6, 3)

    trace: List[dict] = []
    pids = sorted({d["rank"] for d in event_dicts} | {pid for pid, _ in ring})
    for pid in pids:
        # negative pids are synthetic lanes (events.BROKER_RANK) — name
        # them for what they are so Perfetto rows read "broker", not
        # "rank -1"
        lane = f"rank {pid}" if pid >= 0 else \
            "outside ranks" if pid == OUTSIDE_RANKS else "broker"
        trace.append({"ph": "M", "pid": pid, "tid": 0,
                      "name": "process_name",
                      "args": {"name": lane}})
        trace.append({"ph": "M", "pid": pid, "tid": 0,
                      "name": "process_sort_index",
                      "args": {"sort_index": pid}})
        trace.append({"ph": "M", "pid": pid, "tid": 0,
                      "name": "thread_name",
                      "args": {"name": lane}})
    for d in event_dicts:
        rank = d["rank"]
        args = {k: d[k] for k in ("cid", "seq", "peer", "tag", "count",
                                  "dtype", "algo") if d.get(k) is not None}
        if d["t_start"] is not None and d["t_end"] is not None:
            ts = us(d["t_start"], rank)
            trace.append({
                "ph": "X", "pid": rank, "tid": 0, "name": d["op"],
                "cat": d["kind"], "ts": ts,
                "dur": max(0.001, round((d["t_end"] - d["t_start"]) * 1e6, 3)),
                "args": args,
            })
            for name, p0, p1 in d.get("phases") or ():
                # clip to the parent slice so Perfetto nests cleanly
                p0 = max(p0, d["t_start"])
                p1 = min(p1, d["t_end"])
                if p1 <= p0:
                    continue
                trace.append({
                    "ph": "X", "pid": rank, "tid": 0, "name": name,
                    "cat": "phase", "ts": us(p0, rank),
                    "dur": max(0.001, round((p1 - p0) * 1e6, 3)),
                })
        elif d["t"] is not None:
            trace.append({
                "ph": "i", "pid": rank, "tid": 0, "name": d["op"],
                "cat": d["kind"], "ts": us(d["t"], rank), "s": "t",
                "args": args,
            })
    for pid, r in ring:
        args = {"depth": r.depth}
        if r.cpu_ns >= 0:
            args["cpu_us"] = round(r.cpu_ns / 1e3, 3)
        trace.append({
            "ph": "X", "pid": pid, "tid": r.thread, "name": r.name,
            "cat": "ring", "ts": us(r.t0_ns / 1e9, pid),
            "dur": max(0.001, round((r.t1_ns - r.t0_ns) / 1e3, 3)),
            "args": args,
        })
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "otherData": {"tool": "tpu_mpi_torch.analyze.timeline",
                          "schema": SCHEMA}}


def write_chrome(path: str, event_dicts: Sequence[dict],
                 offsets: Optional[Dict[int, float]] = None,
                 ring: Sequence[Any] = ()) -> str:
    """Write :func:`to_chrome` output as JSON; returns the path."""
    rec = to_chrome(event_dicts, offsets, ring)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    os.replace(tmp, path)
    return path


def _span_lane(who: str) -> Optional[int]:
    """Rank whos ("rank 3") map onto the same pid as the event rows so a
    request trace and an event trace merge into one timeline; other actors
    get synthetic pids assigned by spans_to_chrome."""
    if who.startswith("rank "):
        try:
            return int(who.split(None, 1)[1])
        except ValueError:
            return None
    return None


def spans_to_chrome(spans: Sequence[dict]) -> dict:
    """Chrome trace-event JSON from request-span dicts
    (:func:`tpu_mpi_torch.tracectx.drain`).

    One process row per actor: rank spans land on ``pid`` = world rank
    (merging cleanly with :func:`to_chrome` rows); non-rank actors
    (client, router, broker, serve workers) get deterministic pids from
    1000 up in sorted-name order. Every span becomes a ph="X" complete
    slice carrying its trace/span/parent ids and status in ``args``, so
    Perfetto's flow queries (and the CI trace gate) can walk the request
    tree across lanes. Open spans (t1 is None) render with their reason
    visible: status "open" and a 1µs sliver at t0."""
    spans = [s for s in spans if s.get("t0") is not None]
    base = min((s["t0"] for s in spans), default=0.0)
    whos = sorted({s["who"] for s in spans})
    pid_of: Dict[str, int] = {}
    synth = 1000
    for who in whos:
        lane = _span_lane(who)
        if lane is None:
            lane, synth = synth, synth + 1
        pid_of[who] = lane
    trace: List[dict] = []
    for who in whos:
        pid = pid_of[who]
        trace.append({"ph": "M", "pid": pid, "tid": 0,
                      "name": "process_name", "args": {"name": who}})
        trace.append({"ph": "M", "pid": pid, "tid": 0,
                      "name": "process_sort_index",
                      "args": {"sort_index": pid}})
        trace.append({"ph": "M", "pid": pid, "tid": 0,
                      "name": "thread_name", "args": {"name": who}})
    core = ("trace", "span", "parent", "name", "who", "t0", "t1")
    for s in spans:
        t1 = s.get("t1")
        args = {"trace": s["trace"], "span": s["span"],
                "parent": s.get("parent"),
                "status": s.get("status", "ok") if t1 is not None else "open"}
        args.update({k: v for k, v in s.items()
                     if k not in core and k != "status" and v is not None})
        dur = (t1 - s["t0"]) * 1e6 if t1 is not None else 1.0
        trace.append({
            "ph": "X", "pid": pid_of[s["who"]], "tid": 0,
            "name": s["name"], "cat": "span",
            "ts": round((s["t0"] - base) * 1e6, 3),
            "dur": max(0.001, round(dur, 3)), "args": args,
        })
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "otherData": {"tool": "tpu_mpi_torch.analyze.timeline",
                          "schema": SCHEMA, "content": "spans"}}


def write_spans(path: str, spans: Sequence[dict]) -> str:
    """Write :func:`spans_to_chrome` output as JSON; returns the path."""
    rec = spans_to_chrome(spans)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    os.replace(tmp, path)
    return path


def merge_trace(comm: Any, path: Optional[str] = None,
                rounds: int = 5) -> Optional[dict]:
    """Cross-rank merged Chrome trace (collective: every rank calls).

    Aligns clocks via :func:`clock_offsets`, gathers every rank's local
    events to comm rank 0, and returns the merged trace object there
    (writing ``path`` when given); other ranks return None. On the thread
    tier all ranks share one tracer, so rank 0 sends nothing and
    duplicates are dropped by (rank, kind, cid, seq) identity."""
    from ..pointtopoint import recv, send
    offs = clock_offsets(comm, rounds=rounds)
    mine = local_events()
    rank, size = comm.rank(), comm.size()
    tag = 271_828     # private-ish tag lane for the gather
    if rank != 0:
        send(mine, 0, tag, comm)
        return None
    seen = set()
    merged: List[dict] = []
    world_of = comm.world_rank_of
    offsets = {world_of(r): offs[r] for r in range(size)}
    for batch in [mine] + [recv(r, tag, comm)[0] for r in range(1, size)]:
        for d in batch:
            key = (d["rank"], d["kind"], d["cid"], d["seq"])
            if key in seen:
                continue
            seen.add(key)
            merged.append(d)
    rec = to_chrome(merged, offsets)
    if path:
        write_chrome(path, merged, offsets)
    return rec
