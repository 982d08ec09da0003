"""RMA race detection: vector-clock happens-before over window epochs —
the port of ``tpu_mpi/analyze/races.py``.

Every origin-side Put/Get/Accumulate is stamped with its rank's vector clock
(:func:`tpu_mpi_torch.analyze.events.rma_access`); ``Win_fence`` joins all ranks'
clocks (accesses of epoch N happen-before every access of epoch N+1, on every
rank) and ``Win_lock``/``Win_unlock`` publish/acquire clocks per
(window, target) — exclusive locks serialize, shared locks only order against
prior exclusive releases. Two accesses to the same target window RACE when

- they come from different origin ranks,
- their element ranges ``[lo, hi)`` overlap,
- at least one writes (any kind-pair except Get/Get; Accumulate/Accumulate
  is ordered element-wise by MPI semantics, so it is exempt too), and
- neither happens-before the other under the recorded clocks (R301).

This is the MPI-RMA analog of the FastTrack-style VC race detectors; one
epoch's same-target concurrent accesses are exactly what MPI-4 §12.7 leaves
undefined.

:func:`detect_donation_races` (R302) covers the registered-buffer fast path
of persistent collectives: in production mode round ``k``'s result lives in
a donated registered slot that the round ``k+2`` ``Start`` re-donates.
Under tracing the fast path is disabled (every round hands back a fresh
array), so the trace alone shows no corruption — but the ``start`` events
carry the ``invalidates=<round-k result id>`` edge, and any later traced
operation that READS that result object after its invalidating Start is a
use that corrupts silently in production. The result objects of the last
few rounds are kept alive by the request (``PersistentCollRequest._results``),
so within the modeled window an id names exactly one array.
"""

from __future__ import annotations

from typing import List

from .diagnostics import Diagnostic


def _hb(a, b) -> bool:
    """a happened-before (or same-op-as) b under the recorded clocks."""
    return b.vc.get(a.origin, 0) >= a.vc.get(a.origin, 0)


def _kind_class(op: str) -> str:
    """"read" (Get), "acc" (Accumulate family — element-wise ordered by MPI
    semantics), or "write" (Put)."""
    op = op.lower()
    if "accumulate" in op or "fetch" in op:
        return "acc"
    if op.startswith("get"):
        return "read"
    return "write"


def _conflict(a, b) -> bool:
    ca, cb = _kind_class(a.op), _kind_class(b.op)
    if ca == "read" and cb == "read":
        return False
    if ca == "acc" and cb == "acc":
        return False
    return True


def _overlap(a, b) -> bool:
    return not (a.hi <= b.lo or b.hi <= a.lo)


def detect_races(tr) -> List[Diagnostic]:
    """All R301 races in the tracer's RMA event log."""
    out: List[Diagnostic] = []
    seen = set()
    with tr.lock:
        events = list(tr.rma_events)
    # group by (window, target rank): only same-target accesses share memory
    groups: dict = {}
    for ev in events:
        groups.setdefault((ev.win, ev.peer), []).append(ev)
    for evs in groups.values():
        for i in range(len(evs)):
            a = evs[i]
            for j in range(i + 1, len(evs)):
                b = evs[j]
                if a.origin == b.origin:
                    continue        # program order on one rank is ordered
                if not _conflict(a, b) or not _overlap(a, b):
                    continue
                if _hb(a, b) or _hb(b, a):
                    continue
                # anchor at the later event, point back at the earlier one
                first, second = (a, b) if a.t <= b.t else (b, a)
                key = (a.win, frozenset((a.origin, b.origin)),
                       first.file, first.line, second.file, second.line)
                if key in seen:
                    continue
                seen.add(key)
                out.append(Diagnostic(
                    "R301",
                    f"concurrent overlapping RMA accesses: "
                    f"{first.op} by world rank {first.origin} and "
                    f"{second.op} by world rank {second.origin} both touch "
                    f"[{max(a.lo, b.lo)}, {min(a.hi, b.hi)}) of world rank "
                    f"{a.peer}'s window in one exposure epoch",
                    file=second.file, line=second.line, rank=second.origin,
                    context="no happens-before edge between the accesses",
                    related=((first.file, first.line,
                              f"the other access ({first.op} by world rank "
                              f"{first.origin})"),)))
    out.sort(key=lambda d: (d.file, d.line, d.code))
    return out


def detect_donation_races(tr) -> List[Diagnostic]:
    """All R302 uses of a donated persistent-fold result after the Start
    that re-donates its registered slot (see module docstring)."""
    out: List[Diagnostic] = []
    by_rank: dict = {}
    for ev in tr.events():
        by_rank.setdefault(ev.rank, []).append(ev)
    for rank, evs in sorted(by_rank.items()):
        evs.sort(key=lambda e: e.t or 0.0)
        produced: dict = {}      # bufid -> the wait event that returned it
        invalidated: dict = {}   # bufid -> (invalidating start, round)
        for ev in evs:
            if ev.kind == "wait" and ev.bufid is not None:
                # a NEW result now owns this id: any stale invalidation
                # entry refers to a dead object, not to this one
                produced[ev.bufid] = ev
                invalidated.pop(ev.bufid, None)
            elif ev.kind == "start":
                if ev.bufid is not None and ev.bufid in produced:
                    invalidated[ev.bufid] = (ev, ev.round)
                # results older than the request's keep-alive window may be
                # garbage-collected, after which CPython can reuse the id —
                # retire their invalidation entries instead of guessing
                if ev.round is not None:
                    for bid, (sev, rnd) in list(invalidated.items()):
                        if sev.handle == ev.handle and rnd is not None \
                                and rnd <= ev.round - 4:
                            del invalidated[bid]
            elif ev.kind in ("send", "coll") and ev.bufid is not None \
                    and ev.bufid in invalidated:
                sev, _rnd = invalidated.pop(ev.bufid)
                wev = produced.get(ev.bufid)
                rel = [(sev.file, sev.line,
                        f"the Start (round {sev.round}) that re-donates the "
                        f"result's registered slot")]
                if wev is not None:
                    rel.append((wev.file, wev.line,
                                f"the Wait (round {wev.round}) that handed "
                                f"the result to the user"))
                out.append(Diagnostic(
                    "R302",
                    f"{ev.op} reads the round-{wev.round if wev else '?'} "
                    f"result of a persistent {sev.op} after the round-"
                    f"{sev.round} Start invalidated its donated buffer — "
                    f"under the registered fast path this reads data the "
                    f"in-flight round is overwriting",
                    file=ev.file, line=ev.line, rank=rank,
                    context="trace ran the safe legacy lane; the hazard is "
                            "the production registered path",
                    related=tuple(rel)))
    out.sort(key=lambda d: (d.file, d.line, d.code))
    return out
