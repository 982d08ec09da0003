"""Time the front door's ``enter`` and ``copy`` phases of an ``Allreduce``
spent off the CPU: their wall time less the thread's CPU time over them,
from the program's span ring over the profiled window, per rank-op, in
microseconds. Neither phase waits by design, so this is the GIL, a lock,
preemption, or a launch blocked on the card's full queue (a span cannot
tell them apart). ``fold`` is left out: the last arriver's fold launches
the kernel, and in a card-bound run the launch blocks while the card's
queue is full, so its time off the CPU is the card's backpressure.
``rendezvous`` is a rank waiting for its peers. Layer: front door."""

import bisect

PHASES = ("enter", "copy")


def read(v):
    spans = getattr(v, "program_spans", None)
    rank_ops = v.ops * v.facts.ranks
    if not spans or not rank_ops:
        return None
    ops = {}
    for s in spans:
        if s.name == "allreduce":
            ops.setdefault(s.thread, []).append((s.t0_ns, s.t1_ns))
    starts = {t: [a for a, _ in iv] for t, iv in ops.items()}
    off, seen = 0, False
    for s in spans:
        if s.name not in PHASES or s.thread not in ops or s.cpu_ns < 0:
            continue
        i = bisect.bisect_right(starts[s.thread], s.t0_ns) - 1
        if i >= 0 and s.t1_ns <= ops[s.thread][i][1]:
            off += s.t1_ns - s.t0_ns - s.cpu_ns
            seen = True
    return off / rank_ops / 1e3 if seen else None
