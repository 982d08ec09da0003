"""The latent-attention backward's roofline reader
(``metrics/attention_bwd_roofline.moonlight.py``) on made-up counters."""

import math

from portbench import harness


class _View:
    def __init__(self, counters, has_trace=True):
        self.facts = harness.Facts(attempted=1, failed=0, ops=1, window=(0, 1), setup_s=0,
                                   memory_peak_bytes=0, numbers={}, counters=counters)
        self.has_trace = has_trace


def _read():
    return harness.metric_reader("attention_bwd_roofline.moonlight")


def test_bound_at_the_cell_shape():
    import importlib.util
    path = harness.HERE / "metrics" / "attention_bwd_roofline.moonlight.py"
    spec = importlib.util.spec_from_file_location("bwd_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # 2 x 64 x 8,390,656 pairs x (3 x 192 + 2 x 128) at 989 TFLOP/s
    assert abs(mod.least_s(64, 4096, 192, 128) * 1e3 - 0.90350) < 1e-4


def test_both_passes_count_and_the_rest_does_not():
    least = 0.90350
    c = {"device_ms": {"void sm90::attention_backward_sm90_kernel<192, 128, 3>(x)": 2 * least,
                       "void sm90::attention_backward_sm90_dq_kernel<192, 128, 3>(x)": 2 * least,
                       "void sm90::attention_backward_prep_kernel<192>(x)": 100.0,
                       "void sm90::ring_attention_sm90_kernel<192, 128, 3>(x)": 100.0},
         "device_launches": {"void sm90::attention_backward_sm90_kernel<192, 128, 3>(x)": 2,
                             "void sm90::attention_backward_sm90_dq_kernel<192, 128, 3>(x)": 2,
                             "void sm90::attention_backward_prep_kernel<192>(x)": 2,
                             "void sm90::ring_attention_sm90_kernel<192, 128, 3>(x)": 2},
         "shapes": {"attention": [64, 4096, 192, 128]}}
    assert math.isclose(_read()(_View(c)), 50.0, rel_tol=1e-4)


def test_silent_without_the_kernel_or_a_trace():
    forward_only = {"device_ms": {"void sm90::ring_attention_sm90_kernel<192, 128, 3>(x)": 1.0},
                    "device_launches": {"void sm90::ring_attention_sm90_kernel<192, 128, 3>(x)": 1},
                    "shapes": {"attention": [64, 4096, 192, 128]}}
    assert _read()(_View(forward_only)) is None
    assert _read()(_View({})) is None
    kernel = {"device_ms": {"attention_backward_sm90_kernel<192, 128, 3>": 1.0},
              "device_launches": {"attention_backward_sm90_kernel<192, 128, 3>": 1},
              "shapes": {"attention": [64, 4096, 192, 128]}}
    assert _read()(_View(kernel, has_trace=False)) is None
