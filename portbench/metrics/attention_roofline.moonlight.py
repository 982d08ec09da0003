"""The latent-attention kernel's share of its roofline: its least time (the
larger of its operations at the bf16 peak and its bytes at the HBM peak,
from the launch's shape: every rank's batch-heads, t, q/k head dim 192 and
v head dim 128) times its launches, over its device time, both from the
profiled window's device operations (the sm90 kernel at those head dims,
``ring_attention_sm90_kernel<192``), which the driver sums by name into the
counters. Layer: kernels."""

KERNEL = "ring_attention_sm90_kernel<192"


def read(v):
    c = v.facts.counters
    ms, launches = c.get("device_ms") or {}, c.get("device_launches") or {}
    shape = (c.get("shapes") or {}).get("attention")
    names = [k for k in ms if KERNEL in k]
    if not v.has_trace or not names or not shape:
        return None
    from portbench.counts_moonlight import attention_least_s
    took = sum(ms[k] for k in names)
    count = sum(launches[k] for k in names)
    return 100.0 * attention_least_s(*shape) * 1e3 * count / took if took > 0 else None
