"""The whole train step's share of the card's bf16 peak: the model FLOPs of
a step from its shapes (the forward three times, causal attention at the
pairs it keeps) times the steps of the timed window, over that window, in
percent. The timed window runs without the profiler, so the share is the
one the cell's throughput shows. One reader for every cell's
``train_step_mfu.<cell kind>``. Layer: model step."""


def read(v):
    f = v.facts
    if not f.flops_per_step or not f.ops:
        return None
    from portbench.counts import PEAK_BF16_FLOPS
    return 100.0 * f.flops_per_step * f.ops / f.window_s / PEAK_BF16_FLOPS
