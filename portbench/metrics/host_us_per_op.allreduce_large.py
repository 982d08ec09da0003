"""Host time of an op that the card's work does not cover: the benchmark's
span of each ``Allreduce`` (first rank's call to last rank's return) less
the device's busy time inside it, per op, in microseconds. Near 0 while the
card is the bottleneck (the host waits on it inside its spans); it grows
when the host holds the card back. Layer: front door."""


def read(v):
    if not v.has_trace or not v.op_spans or v.busy_ns <= 0:
        return None
    from portbench.trace import union, within
    spanned = sum(b - a for a, b in union(v.op_spans))
    return (spanned - within(v.busy, v.op_spans)) / v.ops / 1e3
