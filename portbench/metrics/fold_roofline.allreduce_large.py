"""The op's least time (every rank's operand read once and the result
written once, at the HBM peak) times the ops of the window, over the
device's busy time in the window, in percent. The window holds the ops and
nothing else and ends with a synchronise, so its busy time is theirs, also
where the host has run ahead of the card and the last ops' work falls
after the last span. It reads the same work whatever kernels do the fold.
Layer: kernels."""


def read(v):
    if not v.has_trace or v.facts.bytes_per_op <= 0 or v.busy_ns <= 0:
        return None
    from portbench.counts import fold_least_s
    least = fold_least_s(v.facts.ranks, v.facts.bytes_per_op) * 1e9
    return 100.0 * least * v.ops / v.busy_ns
