"""The mean step time in the profiled window, in milliseconds: beside the
timed window's rate it shows how far the profiler slowed the host, so that
``device_idle.<cell kind>`` of the same window can be read as the card's
idle share at that pace. One reader for every cell's
``traced_step_ms.<cell kind>``. Layer: device."""


def read(v):
    if not v.has_trace or not v.ops:
        return None
    return v.window_ns / v.ops / 1e6
