"""Time the forward pass spent off the CPU: the wall time of the program's
``model.forward`` spans less the thread's CPU time over them, from the span
ring over the profiled window, per rank-step, in milliseconds. Only spans
with a CPU reading count: those of ``transformer_forward``, which the DDP
cell's rank threads call, where this is waiting on the GIL or preempted
while another rank thread runs. The model step's own ``model.forward``
phase carries none (``cpu_ns`` -1), so the sp cell reads nothing. Layer:
model step."""


def read(v):
    spans = getattr(v, "program_spans", None)
    rank_steps = v.ops * v.facts.ranks
    if not spans or not rank_steps:
        return None
    timed = [s for s in spans if s.name == "model.forward" and s.cpu_ns >= 0]
    if not timed:
        return None
    return sum(s.t1_ns - s.t0_ns - s.cpu_ns for s in timed) / rank_steps / 1e6
