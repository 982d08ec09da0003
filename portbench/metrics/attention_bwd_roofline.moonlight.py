"""The latent-attention backward's share of its roofline: its least time
(the larger of its operations, 2 (3 dq + 2 dv) a causal pair of every
batch-head, at the bf16 peak, and the bytes of q, k, v, o, dO and the three
gradients, bfloat16, each once, at the HBM peak; from the forward's launch
shape) times its calls, over the device time of the backward's main
launches in the profiled window, which ``drivers/moe_train.py`` sums by
name into the counters. At q/k 192 the backward makes two main launches a call: the dK
and dV pass (``attention_backward_sm90_kernel<192``, counted as the calls)
and the dQ pass (``attention_backward_sm90_dq_kernel<192``). Its small
launch, which writes the rows' D beside the forward's log-sum-exp
(``attention_backward_prep_kernel``), matches neither name and is left out,
as is the forward (``ring_attention_sm90_kernel``). Layer: kernels."""

PASSES = ("attention_backward_sm90_kernel<192", "attention_backward_sm90_dq_kernel<192")


def least_s(bh: int, t: int, dq: int, dv: int) -> float:
    """The least time of one backward call of ``bh`` batch-heads over a
    causal sequence of t at q/k head dim dq and v head dim dv."""
    from portbench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, causal_pairs
    flops = 2 * bh * causal_pairs(t) * (3 * dq + 2 * dv)
    nbytes = 2 * bh * t * (4 * dq + 4 * dv)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def read(v):
    c = v.facts.counters
    ms, launches = c.get("device_ms") or {}, c.get("device_launches") or {}
    shape = (c.get("shapes") or {}).get("attention")
    calls = sum(n for k, n in launches.items() if PASSES[0] in k)
    took = sum(t for k, t in ms.items() if any(p in k for p in PASSES))
    if not v.has_trace or not calls or not shape or took <= 0:
        return None
    return 100.0 * least_s(*shape) * 1e3 * calls / took
