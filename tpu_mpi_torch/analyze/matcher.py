"""DeadlockError dump: per-rank pending operations and the wait-for cycle.

The JAX package's module of the same name is also the cross-rank trace
verifier (``verify_trace``); that part comes with the analysis slice of the
port (ROADMAP Queue A item 11). The runtime's ``raise_deadlock`` reads only
:func:`deadlock_report`, which lives here.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


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
            now = time.monotonic()
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
