"""The trace arithmetic and the per-layer readers on a made-up trace."""

from portbench import harness, trace


def test_union_overlap_and_busy():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]
    assert trace.overlap_ns([(0, 3), (5, 9)], [(2, 6)]) == 2
    ops = [("k", 0, 3), ("k", 2, 4), ("m", 10, 20)]
    assert trace.busy(ops, (1, 15)) == [(1, 4), (10, 15)]
    assert trace.top_ops(ops, (0, 100)) == [["m", 10e-9], ["k", 5e-9]]


def test_idle_split_by_the_span_the_host_was_in():
    busy = [(10, 20), (50, 60)]
    spans = [("Allreduce", 0, 30), ("trainer.step", 30, 45)]
    got = dict(trace.idle_by_span(busy, (0, 70), spans))
    assert got == {"Allreduce": 20e-9, "trainer.step": 15e-9, "outside_spans": 15e-9}


def facts(**kw):
    base = dict(attempted=10, failed=0, ops=10, window=(0, 10**9), setup_s=1.0,
                memory_peak_bytes=0, numbers={}, bytes_per_op=1 << 28, ranks=4,
                flops_per_step=10**12)
    base.update(kw)
    return harness.Facts(**base)


def view(f, busy, op_spans):
    return harness.View(facts=f, ops=f.ops, has_trace=True, window=(0, 10**9), busy=busy,
                        op_spans=op_spans, rank0_spans=[])


def test_readers_on_a_made_up_window():
    f = facts(ops=1000)
    # 1000 ops of 0.5 ms busy each in a 1 s window: 50 % idle
    busy = [(i * 10**6, i * 10**6 + 500_000) for i in range(1000)]
    spans = [(i * 10**6, (i + 1) * 10**6) for i in range(1000)]
    v = view(f, busy, spans)
    idle = harness.metric_reader("device_idle.sp")(v)
    assert abs(idle - 50.0) < 1e-9
    roof = harness.metric_reader("fold_roofline.allreduce_large")(v)
    assert abs(roof - 100 * 0.40065 / 0.5) < 0.01
    host = harness.metric_reader("host_us_per_op.allreduce_large")(v)
    assert abs(host - 500.0) < 1e-6
    mfu = harness.metric_reader("train_step_mfu.sp")(v)
    assert abs(mfu - 100 * 1e12 * 1000 / 989e12) < 1e-9
    assert abs(harness.metric_reader("traced_step_ms.sp")(v) - 1.0) < 1e-12


def test_mfu_reads_the_timed_window_not_the_traced_one():
    # 100 steps in the timed second; the profiled window is slower
    f = facts(ops=100, traced_ops=50, traced_window=(2 * 10**9, 3 * 10**9))
    v = harness.View(facts=f, ops=50, has_trace=True, window=(0, 10**9), busy=[(0, 10**8)],
                     op_spans=[], rank0_spans=[])
    mfu = harness.metric_reader("train_step_mfu.ddp")(v)
    assert abs(mfu - 100 * 1e12 * 100 / 989e12) < 1e-9
    assert abs(harness.metric_reader("traced_step_ms.ddp")(v) - 20.0) < 1e-12


def test_readers_without_a_trace_read_nothing():
    f = facts()
    v = harness.View(facts=f, ops=10, has_trace=False, window=(0, 10), busy=[], op_spans=[],
                     rank0_spans=[])
    for name in ("device_idle.sp", "fold_roofline.allreduce_large",
                 "host_us_per_op.allreduce_large", "traced_step_ms.sp",
                 "ddp_trainer_ms_per_step", "ddp_wait_ms_per_step"):
        assert harness.metric_reader(name)(v) is None, name


class StubTrace:
    """Stands in for the device profiler on the CPU: counts its windows."""

    def __init__(self):
        self.started = self.stopped = 0

    def start(self):
        self.started += 1

    def stop(self):
        self.stopped += 1


def test_a_traced_run_profiles_a_window_after_the_timed_one():
    import importlib

    import torch

    from conftest import ROOT, tiny
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    for w in manifest["workloads"]:
        t = tiny(w["name"])
        stub = StubTrace()
        cell = harness.Cell(w["name"], t["config"], t["traffic"], 2 ** 31 + 3, 0.3,
                            torch.device("cpu"), trace.Spans(), stub)
        f = importlib.import_module(f"portbench.drivers.{t['traffic']['driver']}").run(cell)
        assert stub.started == stub.stopped == 1, w["name"]
        assert f.ops > 0 and f.traced_ops > 0, w["name"]
        assert f.window[1] <= f.traced_window[0], w["name"]
