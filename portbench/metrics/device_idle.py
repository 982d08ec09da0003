"""The device's idle share of the traced window: 1 less the union of its
operations' spans over the window, in percent. Layer: device. One reader
for every cell's ``device_idle.<cell kind>``."""


def read(v):
    if not v.has_trace or v.busy_ns <= 0:
        return None
    return 100.0 * (1.0 - v.busy_ns / v.window_ns)
