"""Time ``DDPTrainer.step``'s packing, ``Start``s and fold spent off the
CPU: the wall time of the program's ``ddp.pack``, ``ddp.start`` and
``ddp.optimizer`` spans less the thread's CPU time over them, from the span
ring over the profiled window, per rank-step, in milliseconds. None of the
three waits by design, so this is the GIL, a lock, preemption, or a kernel
launch blocked on the card's full queue (a span cannot tell them apart).
Spans without a CPU reading (``cpu_ns`` -1) are left out. Layer:
trainer."""

NAMES = ("ddp.pack", "ddp.start", "ddp.optimizer")


def read(v):
    spans = getattr(v, "program_spans", None)
    rank_steps = v.ops * v.facts.ranks
    if not spans or not rank_steps:
        return None
    timed = [s for s in spans if s.name in NAMES and s.cpu_ns >= 0]
    if not timed:
        return None
    return sum(s.t1_ns - s.t0_ns - s.cpu_ns for s in timed) / rank_steps / 1e6
