"""The card's time on the MoE layers, forward and backward, per step of the
profiled window, in milliseconds: the device operations launched while one
of the program's MoE spans was open on the launching thread (the forward's
``model.moe.route``, ``.dispatch``, ``.experts`` and ``.combine``, and each
layer's ``model.moe.backward`` on autograd's thread), each matched to its
launch by correlation id, which the driver sums into ``moe_device_ms``.
Nothing when some of the window's device time could not be matched to a
launch. Layer: model step."""

UNMATCHED_SHARE = 0.01      # of the window's device time, at most


def read(v):
    c = v.facts.counters or {}
    if not v.has_trace or not v.ops or "moe_device_ms" not in c:
        return None
    if c["unmatched_device_ms"] > UNMATCHED_SHARE * sum(c["device_ms"].values()):
        return None
    return c["moe_device_ms"] / v.ops
