"""The card's idle time inside one phase of the model step, per step, in
milliseconds: over the program's ``model.<phase>`` spans from the span ring
in the profiled window, each span's length less the card's busy time inside
it. One reader for ``idle_ms_per_step.forward``, ``.backward``,
``.grad_sum`` and ``.update``: the harness loads this file once for each,
under a module name that ends in the metric's name, and the phase is read
from it. Layer: model step."""

PHASE = __name__.rsplit(".", 1)[-1]


def read(v):
    spans = getattr(v, "program_spans", None)
    if not v.has_trace or not spans or not v.ops:
        return None
    from portbench.trace import clip, overlap_ns, union
    mine = union(clip([(s.t0_ns, s.t1_ns) for s in spans
                       if s.name == f"model.{PHASE}"], *v.window))
    if not mine:
        return None
    idle = sum(b - a for a, b in mine) - overlap_ns(v.busy, mine)
    return idle / v.ops / 1e6
