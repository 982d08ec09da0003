"""The pairwise all-to-all kernel's share of its roofline in the MoE
layers: each exchange's least time (the routed rows' bytes read once and
written once at the HBM peak; padding not counted, so the yardstick is the
same whatever moves the rows) times the exchanges, over the kernel's device
time, both from the profiled window's device operations (``alltoall_kernel``),
which the driver sums by name into the counters. Every exchange of the
step, forward and backward, moves the routed rows of one layer. Layer:
kernels."""

KERNEL = "alltoall_kernel"


def read(v):
    c = v.facts.counters
    ms, launches = c.get("device_ms") or {}, c.get("device_launches") or {}
    shapes = c.get("shapes") or {}
    names = [k for k in ms if KERNEL in k]
    if not v.has_trace or not names or not shapes.get("routed_rows"):
        return None
    from portbench.counts_moonlight import alltoall_least_s
    took = sum(ms[k] for k in names)
    count = sum(launches[k] for k in names)
    least = alltoall_least_s(shapes["routed_rows"], shapes["d_model"]) * 1e3
    return 100.0 * least * count / took if took > 0 else None
