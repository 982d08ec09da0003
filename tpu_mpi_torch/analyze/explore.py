"""Schedule-space verification: DPOR-style exploration over one trace.

One recorded run (a :class:`tpu_mpi_torch.analyze.events.Tracer`, live or loaded
back from ``TPU_MPI_TRACE_DUMP`` files) fixes each rank's *program*: the
sequence of communication operations that rank performed. The runtime chose
ONE schedule for that program's nondeterministic choice points; this module
re-executes the per-rank programs over an abstract machine and enumerates
the others:

- **wildcard receive matchings** — a receive posted with ``ANY_SOURCE``
  (the ``want`` slot is None) may match any in-flight message; per source,
  MPI's non-overtaking rule pins the first tag-match, so the branch set is
  "one candidate per sender";
- **persistent Start/Wait reorderings** — ``start`` events mark a round
  begun, the matching ``wait`` blocks until every participant started it;
  the interleavings of different ranks' Start/Wait pairs are explored like
  any other transitions;
- **dispatcher/collective interleavings** — collectives (including the
  ULFM ``Comm_agree``/``Comm_shrink`` steps and the serve pool's rounds)
  are synchronizing transitions over the participant set *observed in the
  trace*, so a world already shrunk does not dead-wait on its dead ranks.

Each maximal schedule is checked for

- **T210** deadlock: a non-terminal state with no enabled transition — the
  diagnostic carries the per-rank executed-event listing of the schedule
  that got there plus each rank's pending operation;
- **T211** orphaned messages: a terminal schedule that leaves sent
  messages unreceived;
- **T212** value divergence: a wildcard receive that observes messages
  with *different payload signatures* (tag/count/dtype — deliberately not
  the source itself, or every explored matching would count) depending on
  the schedule.

Reduction. Deterministic transitions (sends, collectives whose
participants all arrived, exact-source receives — FIFO per sender makes
their match unique — starts, and waits) are executed eagerly without
branching: they are persistent in the DPOR sense, since no other rank's
transition can change what they do. Branching happens only at quiescence
(no deterministic transition enabled) and only over wildcard-receive
candidates; converging interleavings are pruned by a visited-state sleep
set keyed on (program counters, channel contents, started rounds). Small
worlds — up to ~8 ranks and a few hundred events — verify in well under a
second; ``max_schedules``/``max_states`` bound the walk and set
``truncated`` when they bite (never silently).

The model is an *eager-buffered* MPI: sends never block, receives block
until a match is in flight, collectives block until every observed
participant arrives. Branch sets are formed at quiescence, so a match that
only becomes available after ANOTHER rank's later wildcard choice can be
missed (the classic POE approximation) — exploration is sound (a reported
deadlock is reachable under the model) but not exhaustive.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from .diagnostics import Diagnostic

# ---------------------------------------------------------------------------
# Per-rank programs: trace events -> transitions
# ---------------------------------------------------------------------------


class _Tx:
    """One transition of one rank's re-executable program."""

    __slots__ = ("kind", "rank", "op", "cid", "dst", "want", "wtag", "tag",
                 "count", "dtype", "key", "file", "line", "idx")

    def __init__(self, kind, rank, op, **kw):
        # "send" | "recv" | "coll" (rendezvous) | "start" | "pwait" | "local"
        self.kind = kind
        self.rank = rank
        self.op = op
        for name in self.__slots__[3:]:
            setattr(self, name, kw.get(name))

    def describe(self) -> str:
        if self.kind == "send":
            return f"{self.op}(dst=rank {self.dst}, tag={self.tag})"
        if self.kind == "recv":
            src = "ANY_SOURCE" if self.want is None else f"rank {self.want}"
            tag = "ANY_TAG" if self.wtag is None else self.wtag
            return f"{self.op}(src={src}, tag={tag})"
        if self.kind in ("coll", "start", "pwait"):
            return f"{self.op} on comm {self.cid}"
        return f"{self.op}"


def _build_programs(tr) -> Tuple[Dict[int, List[_Tx]], Dict[Any, frozenset]]:
    """(rank -> transition list, rendezvous key -> observed participants)."""
    progs: Dict[int, List[_Tx]] = {}
    ft_ord: Dict[tuple, int] = defaultdict(int)
    for rank in sorted(r for r in tr.rings if r >= 0):
        prog: List[_Tx] = []
        for ev in tr.events(rank):
            tx = None
            if ev.kind == "send":
                tx = _Tx("send", rank, ev.op, cid=ev.cid, dst=ev.peer,
                         tag=ev.tag, count=ev.count, dtype=ev.dtype,
                         file=ev.file, line=ev.line)
            elif ev.kind == "recv":
                tx = _Tx("recv", rank, ev.op, cid=ev.cid, want=ev.want,
                         wtag=ev.wtag, file=ev.file, line=ev.line)
            elif ev.kind == "coll":
                if ev.handle is not None:
                    continue    # persistent round: modeled by start/wait
                key = ("coll", ev.cid, ev.grp, ev.seq)
                tx = _Tx("coll", rank, ev.op, cid=ev.cid, key=key,
                         file=ev.file, line=ev.line)
            elif ev.kind == "start":
                key = ("round", ev.cid, ev.op, ev.round)
                tx = _Tx("start", rank, ev.op, cid=ev.cid, key=key,
                         file=ev.file, line=ev.line)
            elif ev.kind == "wait":
                key = ("round", ev.cid, ev.op, ev.round)
                tx = _Tx("pwait", rank, f"Wait[{ev.op}]", cid=ev.cid,
                         key=key, file=ev.file, line=ev.line)
            elif ev.kind == "ft":
                if ev.op == "Comm_revoke":
                    tx = _Tx("local", rank, ev.op, cid=ev.cid,
                             file=ev.file, line=ev.line)
                else:
                    k = (rank, ev.cid, ev.op)
                    key = ("ft", ev.cid, ev.op, ft_ord[k])
                    ft_ord[k] += 1
                    tx = _Tx("coll", rank, ev.op, cid=ev.cid, key=key,
                             file=ev.file, line=ev.line)
            # "rma"/"sync"/"serve" events carry no matching nondeterminism
            if tx is not None:
                tx.idx = len(prog)
                prog.append(tx)
        progs[rank] = prog
    participants: Dict[Any, set] = defaultdict(set)
    for rank, prog in progs.items():
        for tx in prog:
            if tx.kind in ("coll", "start", "pwait"):
                participants[tx.key].add(rank)
    parts = {k: frozenset(v) for k, v in participants.items()}
    # a rendezvous only one rank ever recorded synchronizes nothing
    for prog in progs.values():
        for tx in prog:
            if tx.kind == "coll" and len(parts[tx.key]) < 2:
                tx.kind = "local"
    return progs, parts


# ---------------------------------------------------------------------------
# Abstract machine state
# ---------------------------------------------------------------------------


class _State:
    __slots__ = ("pcs", "chans", "started", "hist")

    def __init__(self, pcs, chans, started, hist):
        self.pcs: Dict[int, int] = pcs
        # (cid, dst rank) -> {src rank: [ (tag, count, dtype), ... ] FIFO}
        self.chans: Dict[tuple, Dict[int, list]] = chans
        self.started: set = started      # rendezvous round keys begun, per rank
        self.hist: List[tuple] = hist    # (rank, description, file, line)

    def clone(self) -> "_State":
        chans = {k: {s: list(q) for s, q in by_src.items()}
                 for k, by_src in self.chans.items()}
        return _State(dict(self.pcs), chans, set(self.started),
                      list(self.hist))

    def fingerprint(self) -> tuple:
        chans = tuple(sorted(
            (k, tuple(sorted((s, tuple(q)) for s, q in by_src.items() if q)))
            for k, by_src in self.chans.items()
            if any(by_src.values())))
        return (tuple(sorted(self.pcs.items())), chans,
                frozenset(self.started))


def _tag_match(wtag, tag) -> bool:
    return wtag is None or wtag == tag


def _candidates(st: _State, tx: _Tx) -> List[tuple]:
    """(src, tag, count, dtype) matches for a receive — per source, the
    first tag-match in that sender's FIFO (MPI non-overtaking)."""
    by_src = st.chans.get((tx.cid, tx.rank), {})
    srcs = [tx.want] if tx.want is not None else sorted(by_src)
    out = []
    for src in srcs:
        for msg in by_src.get(src, ()):
            if _tag_match(tx.wtag, msg[0]):
                out.append((src,) + msg)
                break
    return out


class _Machine:
    def __init__(self, progs, parts):
        self.progs = progs
        self.parts = parts

    def cur(self, st: _State, rank: int) -> Optional[_Tx]:
        pc = st.pcs[rank]
        prog = self.progs[rank]
        return prog[pc] if pc < len(prog) else None

    def coll_ready(self, st: _State, tx: _Tx) -> bool:
        for r in self.parts[tx.key]:
            other = self.cur(st, r)
            if other is None or other.kind != "coll" or other.key != tx.key:
                return False
        return True

    def wait_ready(self, st: _State, tx: _Tx) -> bool:
        return all((tx.key, r) in st.started for r in self.parts[tx.key])

    def step(self, st: _State, tx: _Tx, chosen: Optional[tuple] = None):
        """Execute ``tx`` (with ``chosen`` = the (src, tag, count, dtype)
        match for a receive), mutating ``st``."""
        rank = tx.rank
        if tx.kind == "coll":
            for r in self.parts[tx.key]:
                st.pcs[r] += 1
            st.hist.append((rank, f"{tx.describe()} "
                                  f"[ranks {sorted(self.parts[tx.key])}]",
                            tx.file, tx.line))
            return
        if tx.kind == "send":
            by_src = st.chans.setdefault((tx.cid, tx.dst), {})
            by_src.setdefault(rank, []).append((tx.tag, tx.count, tx.dtype))
        elif tx.kind == "recv":
            src, tag = chosen[0], chosen[1]
            q = st.chans[(tx.cid, rank)][src]
            for i, msg in enumerate(q):
                if _tag_match(tx.wtag, msg[0]) and msg[0] == tag:
                    del q[i]
                    break
        elif tx.kind == "start":
            st.started.add((tx.key, rank))
        st.pcs[rank] += 1
        detail = tx.describe()
        if tx.kind == "recv" and chosen is not None:
            detail += f" <- matched rank {chosen[0]}, tag {chosen[1]}"
        st.hist.append((rank, detail, tx.file, tx.line))


# ---------------------------------------------------------------------------
# The exploration loop
# ---------------------------------------------------------------------------


class ExploreResult:
    """Outcome of one :func:`explore` run."""

    def __init__(self):
        self.schedules = 0          # maximal schedules reached
        self.deadlocks = 0
        self.states = 0             # quiescent states expanded
        self.truncated = False
        self.diagnostics: List[Diagnostic] = []
        self.ranks: List[int] = []
        self.transitions = 0

    def __repr__(self):
        return (f"<ExploreResult schedules={self.schedules} "
                f"deadlocks={self.deadlocks} states={self.states} "
                f"diagnostics={len(self.diagnostics)}"
                f"{' TRUNCATED' if self.truncated else ''}>")


def _schedule_listing(m: _Machine, st: _State, tail: int = 12) -> str:
    """The deadlocking schedule as a per-rank event listing."""
    lines = []
    for rank in sorted(m.progs):
        mine = [d for r, d, _f, _l in st.hist if r == rank]
        shown = mine[-tail:]
        pre = f"  rank {rank}: "
        body = " ; ".join(shown) if shown else "(no executed events)"
        if len(mine) > len(shown):
            body = f"... {body}"
        tx = m.cur(st, rank)
        if tx is not None:
            body += f" ; BLOCKED at {tx.describe()} ({tx.file}:{tx.line})"
        else:
            body += " ; (finished)"
        lines.append(pre + body)
    return "\n".join(lines)


def explore(obj: Any = None, max_schedules: int = 1000,
            max_states: int = 100000) -> ExploreResult:
    """Enumerate alternate schedules of the traced run ``obj`` (a Tracer, a
    context, a trace-dump path/prefix, or None for the most recent traced
    run) and verify each one. Returns an :class:`ExploreResult` whose
    ``diagnostics`` carry T210/T211/T212 findings."""
    from .matcher import _tracer_of
    if isinstance(obj, str):
        from .events import load_trace
        tr = load_trace(obj)
    else:
        tr = _tracer_of(obj)
    res = ExploreResult()
    if tr is None:
        return res
    progs, parts = _build_programs(tr)
    res.ranks = sorted(progs)
    res.transitions = sum(len(p) for p in progs.values())
    if not progs:
        return res
    m = _Machine(progs, parts)
    init = _State({r: 0 for r in progs}, {}, set(), [])
    stack: List[_State] = [init]
    visited: set = set()
    # (rank, recv index) -> delivered payload signatures across schedules
    recv_sigs: Dict[tuple, set] = defaultdict(set)
    recv_site: Dict[tuple, tuple] = {}
    deadlock_keys: set = set()
    orphan_keys: set = set()

    def eager_step(st: _State) -> bool:
        for rank in sorted(progs):
            tx = m.cur(st, rank)
            if tx is None:
                continue
            if tx.kind in ("local", "send", "start"):
                m.step(st, tx)
                return True
            if tx.kind == "pwait" and m.wait_ready(st, tx):
                m.step(st, tx)
                return True
            if tx.kind == "coll" and m.coll_ready(st, tx):
                m.step(st, tx)
                return True
            if tx.kind == "recv" and tx.want is not None:
                cands = _candidates(st, tx)
                if cands:
                    recv_sigs[(rank, tx.idx)].add(cands[0][1:])
                    recv_site[(rank, tx.idx)] = (tx.file, tx.line, tx.op)
                    m.step(st, tx, cands[0])
                    return True
        return False

    while stack:
        if res.schedules >= max_schedules or res.states >= max_states:
            res.truncated = True
            break
        st = stack.pop()
        while eager_step(st):
            pass
        fp = st.fingerprint()
        if fp in visited:
            # sleep-set hit: a distinct interleaving that converged with an
            # already-expanded state — count the schedule, skip the re-walk
            res.schedules += 1
            continue
        visited.add(fp)
        res.states += 1
        done = all(m.cur(st, r) is None for r in progs)
        if done:
            res.schedules += 1
            for (cid, dst), by_src in st.chans.items():
                for src, q in by_src.items():
                    for tag, count, dtype in q:
                        key = (cid, src, dst, tag)
                        if key in orphan_keys:
                            continue
                        orphan_keys.add(key)
                        res.diagnostics.append(Diagnostic(
                            "T211",
                            f"an explored schedule terminates with the "
                            f"message rank {src} -> rank {dst} (tag={tag}, "
                            f"comm {cid}) still in flight — no receive "
                            f"consumes it on that schedule",
                            rank=src,
                            context=f"{res.schedules} schedule(s) explored "
                                    f"so far"))
            continue
        branches: List[tuple] = []
        for rank in sorted(progs):
            tx = m.cur(st, rank)
            if tx is not None and tx.kind == "recv" and tx.want is None:
                for cand in _candidates(st, tx):
                    branches.append((tx, cand))
        if not branches:
            res.schedules += 1
            res.deadlocks += 1
            key = tuple(sorted(st.pcs.items()))
            if key in deadlock_keys:
                continue
            deadlock_keys.add(key)
            pend = [(r, m.cur(st, r)) for r in sorted(progs)
                    if m.cur(st, r) is not None]
            anchor = pend[0][1]
            res.diagnostics.append(Diagnostic(
                "T210",
                f"an alternate schedule deadlocks: rank(s) "
                f"{[r for r, _ in pend]} block with no enabled transition "
                f"(the recorded run chose a different wildcard matching). "
                f"Schedule:\n{_schedule_listing(m, st)}",
                file=anchor.file, line=anchor.line, rank=anchor.rank,
                context="per-rank listing shows the executed prefix and "
                        "each blocked operation",
                related=tuple((tx.file, tx.line,
                               f"rank {r} blocked in {tx.describe()}")
                              for r, tx in pend)))
            continue
        for tx, cand in branches:
            nxt = st.clone()
            recv_sigs[(tx.rank, tx.idx)].add(cand[1:])
            recv_site[(tx.rank, tx.idx)] = (tx.file, tx.line, tx.op)
            m.step(nxt, tx, cand)
            stack.append(nxt)

    for (rank, idx), sigs in sorted(recv_sigs.items()):
        if len(sigs) > 1:
            f, ln, op = recv_site[(rank, idx)]
            res.diagnostics.append(Diagnostic(
                "T212",
                f"wildcard {op} on rank {rank} observes schedule-dependent "
                f"payloads: {sorted(sigs)} (tag, count, dtype) depending on "
                f"which message the matching picks",
                file=f, line=ln, rank=rank,
                context="the received VALUE depends on the schedule, not "
                        "just the source"))
    res.diagnostics.sort(key=lambda d: (d.code, d.file, d.line))
    return res


# ---------------------------------------------------------------------------
# CLI entry (python -m tpu_mpi_torch.analyze explore <trace prefix or files>)
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m tpu_mpi_torch.analyze explore",
        description="Enumerate and verify alternate schedules of a recorded "
                    "trace (record one with TPU_MPI_TRACE=1 "
                    "TPU_MPI_TRACE_DUMP=<prefix>).")
    p.add_argument("trace", nargs="+",
                   help="trace-dump file(s) or the prefix passed to "
                        "TPU_MPI_TRACE_DUMP")
    p.add_argument("--max-schedules", type=int, default=1000)
    p.add_argument("--max-states", type=int, default=100000)
    args = p.parse_args(argv)
    from .events import load_trace
    tr = load_trace(args.trace if len(args.trace) > 1 else args.trace[0])
    res = explore(tr, max_schedules=args.max_schedules,
                  max_states=args.max_states)
    print(f"explored {res.schedules} schedule(s) over ranks {res.ranks} "
          f"({res.transitions} transitions, {res.states} states"
          f"{', TRUNCATED by budget' if res.truncated else ''})")
    for d in res.diagnostics:
        print(d)
    if res.diagnostics:
        print(f"{len(res.diagnostics)} finding(s)")
        return 1
    print("no schedule-dependent defects found")
    return 0
