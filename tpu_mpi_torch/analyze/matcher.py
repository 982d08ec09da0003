"""Cross-rank trace verification + the DeadlockError wait-for dump.

:func:`verify_trace` consumes one :class:`tpu_mpi_torch.analyze.events.Tracer` and
checks what no single rank can check alone:

- **T201** — ranks of one communicator called *different* collectives in the
  same round (aligned by absolute per-communicator round ordinals, so ring
  eviction cannot misalign the comparison);
- **T202** — same collective, disagreeing signature: root ranks, or
  dtype/count where the caller supplied a precise signature (reductions,
  Bcast — per-rank-varying Gatherv counts are deliberately not compared),
  plus per-peer count agreement for the ``*v`` family: Alltoallv events
  carry ``scounts``/``rcounts`` in ``extra``, and rank i's ``scounts[j]``
  must equal rank j's ``rcounts[i]``;
- **T203** — a sent message that was never received (suppressed when the
  receiver's ring overflowed: absence of evidence is not evidence);
- **T207** — ULFM protocol divergence: ranks of one communicator disagree on
  the agreement epoch, the agreed flag value, or the shrink survivor set in
  the same protocol round;
- **T208** — serve-tier accounting: a broker ``book`` event whose per-tenant
  measured rows fail to partition the pool totals;
- **T214** — elastic rebind participation: a rank the quiesce/resume round
  declares, and which appears in the trace, never recorded the round (it
  skipped the rebind barrier and can race the remap);
- plus any online findings the hooks queued (T206 Isend buffer mutation),
  the RMA race pass (:func:`tpu_mpi_torch.analyze.races.detect_races`), and the
  donated-buffer invalidation pass
  (:func:`tpu_mpi_torch.analyze.races.detect_donation_races`, R302).

:func:`deadlock_report` renders the per-rank pending operations and the
wait-for cycle appended to DeadlockError messages by the runtime watchdog
(``_runtime.raise_deadlock``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

from .diagnostics import Diagnostic


def _tracer_of(obj: Any) -> Optional[Any]:
    from .events import Tracer, last_trace
    if obj is None:
        return last_trace()
    if isinstance(obj, Tracer):
        return obj
    return getattr(obj, "_tracer", None)       # an SpmdContext


def verify_trace(obj: Any = None) -> List[Diagnostic]:
    """All trace-verifier diagnostics for ``obj`` (a Tracer, a context, or
    None for the most recent traced run)."""
    tr = _tracer_of(obj)
    if tr is None:
        return []
    with tr.lock:
        out = list(tr.diagnostics)
    out += _check_collectives(tr)
    out += _check_p2p(tr)
    out += _check_ft(tr)
    out += _check_serve(tr)
    out += _check_elastic(tr)
    out += _check_lock_serialization(tr)
    from .races import detect_donation_races, detect_races
    out += detect_races(tr)
    out += detect_donation_races(tr)
    out.sort(key=lambda d: (d.file, d.line, d.code))
    return out


# ---------------------------------------------------------------------------
# Collective order + signature agreement (T201 / T202)
# ---------------------------------------------------------------------------

def _check_collectives(tr) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    # (cid, group, round ordinal) names one rendezvous across ranks; the
    # group tuple keeps same-cid-different-group comms (COMM_SELF is cid 1
    # on every rank) from being cross-checked.
    rounds: Dict[tuple, list] = defaultdict(list)
    for ev in tr.events():
        if ev.kind == "coll":
            rounds[(ev.cid, ev.grp, ev.seq)].append(ev)
    # cids mix ints with recovery tuples (("shrink", cid, epoch)): str-keyed
    for (cid, grp, seq), evs in sorted(rounds.items(),
                                       key=lambda kv: (str(kv[0][0]),
                                                       kv[0][2])):
        if len(evs) < 2:
            continue                 # size-1 groups have nothing to agree on
        ops = {ev.op for ev in evs}
        if len(ops) > 1:
            by_op: Dict[str, list] = defaultdict(list)
            for ev in evs:
                by_op[ev.op].append(ev)
            majority = max(by_op, key=lambda op: len(by_op[op]))
            minority = [ev for ev in evs if ev.op != majority]
            anchor = min(minority, key=lambda ev: ev.rank)
            out.append(Diagnostic(
                "T201",
                f"world rank {anchor.rank} called {anchor.op!r} while "
                f"rank(s) {sorted(ev.rank for ev in by_op[majority])} called "
                f"{majority!r} in collective round {seq} of comm {cid}",
                file=anchor.file, line=anchor.line, rank=anchor.rank,
                context=f"group {list(grp)}"))
            continue                 # signature checks presume one op
        roots = {ev.root for ev in evs if ev.root is not None}
        if len(roots) > 1:
            anchor = min((ev for ev in evs if ev.root is not None),
                         key=lambda ev: ev.rank)
            out.append(Diagnostic(
                "T202",
                f"root argument disagrees across ranks in {anchor.op}: "
                f"{sorted(roots)} (collective round {seq} of comm {cid})",
                file=anchor.file, line=anchor.line, rank=anchor.rank,
                context=f"group {list(grp)}"))
        # dtype/count agreement is only meaningful for events carrying a
        # precise signature (reductions and Bcast set one; Gatherv-family
        # counts legitimately differ per rank and carry none).
        sigged = [ev for ev in evs if ev.dtype is not None]
        if len(sigged) > 1 and len({ev.dtype for ev in sigged}) > 1:
            anchor = min(sigged, key=lambda ev: ev.rank)
            out.append(Diagnostic(
                "T202",
                f"dtype disagrees across ranks in {anchor.op}: "
                f"{sorted({ev.dtype for ev in sigged})} "
                f"(collective round {seq} of comm {cid})",
                file=anchor.file, line=anchor.line, rank=anchor.rank))
        counted = [ev for ev in evs if ev.count is not None]
        if len(counted) > 1 and len({ev.count for ev in counted}) > 1:
            anchor = min(counted, key=lambda ev: ev.rank)
            out.append(Diagnostic(
                "T202",
                f"element count disagrees across ranks in {anchor.op}: "
                f"{sorted({ev.count for ev in counted})} "
                f"(collective round {seq} of comm {cid})",
                file=anchor.file, line=anchor.line, rank=anchor.rank))
        # T213: algorithm-selection divergence. The selection is required
        # to be a deterministic function of rank-uniform inputs (see
        # tune.select), so one rank recording a different algorithm for
        # the same round means the run mixed tiers — at the proc tier
        # that is a CollectiveMismatchError in flight; at the thread tier
        # it documents a selection-determinism bug. A hierarchical run is
        # ONE logical round here (its sub-collectives are internal
        # alg-tier frames, never separate coll events), so composites
        # stay clean by construction.
        algod = [ev for ev in evs if ev.algo is not None]
        if len(algod) > 1 and len({ev.algo for ev in algod}) > 1:
            by_algo: Dict[str, list] = defaultdict(list)
            for ev in algod:
                by_algo[ev.algo].append(ev)
            majority = max(by_algo, key=lambda a: len(by_algo[a]))
            minority = [ev for ev in algod if ev.algo != majority]
            anchor = min(minority, key=lambda ev: ev.rank)
            out.append(Diagnostic(
                "T213",
                f"algorithm selection disagrees across ranks in "
                f"{anchor.op}: world rank {anchor.rank} selected "
                f"{anchor.algo!r} while rank(s) "
                f"{sorted(ev.rank for ev in by_algo[majority])} selected "
                f"{majority!r} (collective round {seq} of comm {cid})",
                file=anchor.file, line=anchor.line, rank=anchor.rank,
                context=f"group {list(grp)}"))
        out += _check_vector_counts(cid, grp, seq, evs)
    return out


def _check_vector_counts(cid, grp, seq, evs) -> List[Diagnostic]:
    """Per-peer count agreement for ``*v`` collectives: events carrying
    ``scounts``/``rcounts`` in ``extra`` (Alltoallv records both) must
    satisfy ``rank_i.scounts[j] == rank_j.rcounts[i]`` — what rank i ships
    toward peer slot j is exactly what rank j budgeted for peer slot i.
    Position in the count vectors is the rank's index within the group.
    One diagnostic per round (the first disagreeing pair), anchored at the
    lower-rank participant."""
    vevs = [ev for ev in evs
            if isinstance(ev.extra, dict) and "scounts" in ev.extra
            and "rcounts" in ev.extra]
    if len(vevs) < 2:
        return []
    pos = {ev.rank: grp.index(ev.rank) for ev in vevs if ev.rank in grp}
    for a in sorted(vevs, key=lambda ev: ev.rank):
        for b in sorted(vevs, key=lambda ev: ev.rank):
            i, j = pos.get(a.rank), pos.get(b.rank)
            if i is None or j is None:
                continue
            sc, rc = list(a.extra["scounts"]), list(b.extra["rcounts"])
            if len(sc) != len(grp) or len(rc) != len(grp):
                continue       # malformed vectors already fail at runtime
            if sc[j] != rc[i]:
                anchor = a if a.rank <= b.rank else b
                return [Diagnostic(
                    "T202",
                    f"per-peer count disagrees in {anchor.op}: world rank "
                    f"{a.rank} sends {sc[j]} element(s) to world rank "
                    f"{b.rank}, which expects {rc[i]} (collective round "
                    f"{seq} of comm {cid})",
                    file=anchor.file, line=anchor.line, rank=anchor.rank,
                    context=f"group {list(grp)}: scounts[{a.rank}]={sc}, "
                            f"rcounts[{b.rank}]={rc}")]
    return []


# ---------------------------------------------------------------------------
# Send/recv pairing (T203)
# ---------------------------------------------------------------------------

def _check_p2p(tr) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    # (cid, sender world rank, receiver world rank, delivered tag) ->
    # per-direction counts. Recv events record the *delivered* message's
    # concrete tag, so wildcard receives still land in the right bucket.
    sends: Dict[tuple, list] = defaultdict(list)
    recvs: Dict[tuple, int] = defaultdict(int)
    dropped = dict(tr.dropped)
    for ev in tr.events():
        if ev.kind == "send":
            sends[(ev.cid, ev.rank, ev.peer, ev.tag)].append(ev)
        elif ev.kind == "recv" and ev.peer is not None:
            recvs[(ev.cid, ev.peer, ev.rank, ev.tag)] += 1
    for key, evs in sorted(sends.items(),
                           key=lambda kv: (str(kv[0][0]), kv[0][1])):
        cid, src, dst, tag = key
        unmatched = len(evs) - recvs.get(key, 0)
        if unmatched <= 0:
            continue
        if dropped.get(dst):
            continue        # receiver's ring overflowed: recv may be evicted
        for ev in evs[-unmatched:]:
            out.append(Diagnostic(
                "T203",
                f"message sent by world rank {src} to world rank {dst} "
                f"(tag={tag}, comm {cid}) was never received",
                file=ev.file, line=ev.line, rank=src,
                context=f"{len(evs)} send(s), {recvs.get(key, 0)} receive(s) "
                        f"for this (source, destination, tag)"))
    return out


# ---------------------------------------------------------------------------
# ULFM protocol agreement (T207)
# ---------------------------------------------------------------------------

def _canon(v):
    """Hashable form of an ``extra`` field — JSON round-trips the recorded
    survivor tuples back as lists."""
    return tuple(v) if isinstance(v, list) else v


def _check_ft(tr) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    # Alignment can NOT use ev.seq: the ft ordinal mixes Comm_revoke (which
    # only the revoking rank records) with the collective agree/shrink
    # steps. Re-derive a per-(rank, cid, op) ordinal from ring order instead.
    rounds: Dict[tuple, list] = defaultdict(list)
    ordinal: Dict[tuple, int] = defaultdict(int)
    for ev in tr.events():
        if ev.kind != "ft" or ev.op == "Comm_revoke":
            continue
        k = (ev.rank, ev.cid, ev.op)
        rounds[(ev.cid, ev.op, ordinal[k])].append(ev)
        ordinal[k] += 1
    for (cid, op, rnd), evs in sorted(rounds.items(),
                                      key=lambda kv: (str(kv[0][0]),
                                                      str(kv[0][1]),
                                                      kv[0][2])):
        if len(evs) < 2:
            continue        # dead or evicted peers: nothing to compare
        for field, label in (("epoch", "agreement epoch"),
                             ("value", "agreed value"),
                             ("survivors", "survivor set")):
            vals = {ev.rank: _canon((ev.extra or {}).get(field))
                    for ev in evs}
            distinct = {v for v in vals.values() if v is not None}
            if len(distinct) > 1:
                anchor = min(evs, key=lambda ev: ev.rank)
                out.append(Diagnostic(
                    "T207",
                    f"{label} of {op} round {rnd} on comm {cid} diverges "
                    f"across ranks: "
                    + ", ".join(f"rank {r} -> {v}"
                                for r, v in sorted(vals.items())
                                if v is not None),
                    file=anchor.file, line=anchor.line, rank=anchor.rank,
                    context=f"ranks {sorted(vals)}"))
                break       # one diagnostic per divergent round
    return out


# ---------------------------------------------------------------------------
# Elastic rebind quiesce/resume participation (T214)
# ---------------------------------------------------------------------------

def _check_elastic(tr) -> List[Diagnostic]:
    """Every rank an elastic quiesce/resume round *declares* must have
    recorded the round — a declared rank that shows up elsewhere in the
    trace but skipped the rebind barrier would race the remap (the defect
    the two-phase protocol exists to exclude). Ranks wholly absent from
    the trace are not held to it (dead, or ring-evicted)."""
    out: List[Diagnostic] = []
    present = {r for r in tr.rings if r >= 0 and tr.rings[r]}
    rounds: Dict[tuple, list] = defaultdict(list)
    for ev in tr.events():
        if ev.kind != "elastic":
            continue
        declared = _canon((ev.extra or {}).get("declared")) or ()
        rounds[(ev.op, (ev.extra or {}).get("epoch"), declared)].append(ev)
    for (op, epoch, declared), evs in sorted(
            rounds.items(), key=lambda kv: (str(kv[0][1]), kv[0][0])):
        seen = {ev.rank for ev in evs}
        missing = [r for r in declared if r in present and r not in seen]
        if missing:
            anchor = min(evs, key=lambda ev: ev.rank)
            out.append(Diagnostic(
                "T214",
                f"elastic {op} round (epoch {epoch}) declares ranks "
                f"{list(declared)} but rank(s) {missing} never recorded "
                f"it — a rank skipped the rebind barrier and can race "
                f"the remap",
                file=anchor.file, line=anchor.line, rank=anchor.rank,
                context=f"participants {sorted(seen)}"))
    return out


# ---------------------------------------------------------------------------
# Serve-tier book partition (T208)
# ---------------------------------------------------------------------------

def _check_serve(tr) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    flush_no = 0
    for ev in tr.events():
        if ev.kind != "serve" or ev.op != "book" or not ev.extra:
            continue
        flush_no += 1
        totals = ev.extra.get("totals") or {}
        measured = ev.extra.get("measured") or {}
        for field, total in sorted(totals.items()):
            attributed = sum(int((row or {}).get(field, 0) or 0)
                             for row in measured.values())
            if attributed != int(total or 0):
                out.append(Diagnostic(
                    "T208",
                    f"ledger flush {flush_no}: per-tenant measured "
                    f"{field!r} rows sum to {attributed} but the pool "
                    f"total is {total} — cid-ownership attribution lost "
                    f"{int(total or 0) - attributed} unit(s)",
                    file=ev.file, line=ev.line, rank=ev.rank,
                    context=f"tenants {sorted(measured)}"))
    return out


# ---------------------------------------------------------------------------
# Dispatch-lock serialization (T215): the broker's dispatcher records each
# pop under BROKER_RANK; if the dispatch-lock critical sections serialize,
# every rank initiates its first collective per comm in the same relative
# order the dispatcher released them.
# ---------------------------------------------------------------------------

def _check_lock_serialization(tr) -> List[Diagnostic]:
    from .events import BROKER_RANK
    out: List[Diagnostic] = []
    dispatch_order: List[Any] = []          # cids by first dispatch event
    seen: set = set()
    for ev in tr.events(BROKER_RANK):
        if ev.kind == "serve" and ev.op == "dispatch" and ev.cid is not None:
            if ev.cid not in seen:
                seen.add(ev.cid)
                dispatch_order.append(ev.cid)
    if len(dispatch_order) < 2:
        return out
    pos = {cid: i for i, cid in enumerate(dispatch_order)}
    with tr.lock:
        ranks = sorted(r for r in tr.rings if r != BROKER_RANK)
        dropped = dict(tr.dropped)
    for rank in ranks:
        if dropped.get(rank):
            # the ring evicted this rank's early events: its observed first
            # occurrences are not the real first occurrences — stay silent
            continue
        firsts: List[Any] = []
        by_cid: Dict[Any, Any] = {}
        for ev in tr.events(rank):
            if ev.kind == "coll" and ev.cid in pos and ev.cid not in by_cid:
                by_cid[ev.cid] = ev
                firsts.append(ev.cid)
        for a, b in zip(firsts, firsts[1:]):
            if pos[a] > pos[b]:
                ev = by_cid[b]
                out.append(Diagnostic(
                    "T215",
                    f"rank {rank} initiated comm {b}'s first collective "
                    f"before comm {a}'s, but the dispatcher released "
                    f"{a} before {b} — dispatch-lock critical sections "
                    f"did not serialize op initiation",
                    file=ev.file, line=ev.line, rank=rank,
                    context=f"dispatch order {dispatch_order}, "
                            f"rank order {firsts}"))
                break
    return out


# ---------------------------------------------------------------------------
# DeadlockError dump: per-rank pending operations + the wait-for cycle
# ---------------------------------------------------------------------------

def _waits_for(ctx, ev, blocked: Dict[int, Any]) -> List[int]:
    """World ranks ``ev``'s blocked operation is waiting on."""
    if ev.kind in ("send", "recv", "lock"):
        if ev.peer is None:      # ANY_SOURCE: anyone blocked could unblock it
            return [r for r in blocked if r != ev.rank]
        return [ev.peer]
    if ev.kind == "coll" and ev.grp:
        # missing contributors of this round, read off the live channel
        try:
            from .._runtime import _EMPTY
            ch = ctx._channels.get(ev.cid)
            if ch is not None and len(ch.contribs) == len(ev.grp):
                return [wr for i, wr in enumerate(ev.grp)
                        if wr != ev.rank and ch.contribs[i] is _EMPTY]
        except Exception:
            pass
        return [wr for wr in ev.grp if wr != ev.rank]
    return []


def _find_cycle(edges: Dict[int, List[int]]) -> Optional[List[int]]:
    """One directed cycle in the wait-for graph, as a rank list."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {r: WHITE for r in edges}
    path: List[int] = []

    def dfs(r: int) -> Optional[List[int]]:
        color[r] = GREY
        path.append(r)
        for nxt in edges.get(r, ()):
            if nxt not in edges:
                continue
            if color[nxt] == GREY:
                return path[path.index(nxt):]
            if color[nxt] == WHITE:
                cyc = dfs(nxt)
                if cyc is not None:
                    return cyc
        path.pop()
        color[r] = BLACK
        return None

    for r in sorted(edges):
        if color[r] == WHITE:
            cyc = dfs(r)
            if cyc is not None:
                return cyc
    return None


def deadlock_report(ctx: Any) -> str:
    """Multi-line dump of per-rank pending operations and the wait-for
    cycle, appended to DeadlockError messages when tracing is on; armed
    witness runs (TPU_MPI_LOCKCHECK=1) additionally get every thread's
    held-lock set with acquisition sites. Returns "" when there is nothing
    useful to say — never raises (this runs while the job is already
    failing)."""
    lines: List[str] = []
    try:
        tr = getattr(ctx, "_tracer", None)
        blocked = {}
        if tr is not None:
            with tr.lock:
                blocked = dict(tr.blocked)
        if blocked:
            now = time.perf_counter()
            lines.append("per-rank pending operations:")
            edges: Dict[int, List[int]] = {}
            for r in sorted(blocked):
                ev = blocked[r]
                lines.append(f"  world rank {r}: blocked {now - ev.t:.1f}s "
                             f"in {ev.describe()} at {ev.file}:{ev.line}")
                edges[r] = _waits_for(ctx, ev, blocked)
            idle = [r for r in range(getattr(ctx, "size", 0))
                    if r not in blocked]
            if idle:
                lines.append(f"  rank(s) {idle} not blocked in any traced "
                             f"operation")
            cyc = _find_cycle(edges)
            if cyc:
                lines.append("wait-for cycle: " + " -> ".join(
                    f"rank {r}" for r in cyc + [cyc[0]]))
    except Exception:
        pass
    try:
        # witness-armed runs know which locks every thread holds and where
        # it acquired them — the missing half of a deadlock dump
        from .. import locksmith
        witness = locksmith.witness_report()
        if witness:
            lines.append(witness)
    except Exception:
        pass
    return "\n".join(lines)
