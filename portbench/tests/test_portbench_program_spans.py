"""The readers of the program's own spans and counters on made-up views
with known answers: the ``perfvars`` window counters under ``counters``,
and the span ring's records, moved to the trace's clock, as
``program_spans``. Without them (a harness that passes neither) every
reader reads nothing."""

import shutil
import subprocess

from tpu_mpi_torch.perfvars import Span

from portbench import harness

MS = 10**6


def facts(**kw):
    base = dict(attempted=10, failed=0, ops=10, window=(0, 10**9), setup_s=1.0,
                memory_peak_bytes=0, numbers={}, ranks=4)
    base.update(kw)
    return harness.Facts(**base)


def view(f, spans=None, ops=5, busy=(), window=(0, 10**9)):
    v = harness.View(facts=f, ops=ops, has_trace=True, window=window, busy=list(busy),
                     op_spans=[], rank0_spans=[])
    if spans is not None:
        v.program_spans = spans
    return v


def span(name, t0, t1, cpu, rank=0, thread=1, depth=0):
    return Span(rank, thread, name, depth, t0, t1, cpu)


def read(name, v):
    return harness.metric_reader(name)(v)


def test_the_harness_patch_fits_the_benchmark(tmp_path):
    """``program_spans.patch`` holds the harness edits that give these
    readers their inputs (the ring over the profiled window, the view's
    ``program_spans``, the drivers' counters, the ``per_layer`` entries);
    it applies to the benchmark's files as they are, or is applied."""
    import os

    from conftest import ROOT
    patch = ROOT / "portbench" / "program_spans.patch"
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    # a copy inside some repository's tree: git must not take its paths
    # as that repository's
    env = dict(os.environ, GIT_CEILING_DIRECTORIES=str(tmp_path.parent))

    def apply(*flags):
        return subprocess.run(["git", "apply", *flags, str(patch)], cwd=tmp_path, env=env,
                              capture_output=True, text=True)
    if apply("--check", "-R").returncode == 0:
        return
    forward = apply()
    assert forward.returncode == 0, forward.stderr
    listed = {m["name"] for m in harness.load_json(tmp_path / "BENCHMARK.json")["per_layer"]}
    readers = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert {"frontdoor_host_us.allreduce_large", "idle_ms_per_step.update"} <= listed
    assert all(n in readers or n.split(".")[0] in readers for n in listed)


def test_frontdoor_host_time_per_rank_op():
    fd = {"ops": 40, "op_ns": 10**9, "enter_ns": 4000, "rendezvous_ns": 9 * 10**8,
          "fold_ns": 40_000, "copy_ns": 36_000}
    v = view(facts(ops=10, counters={"frontdoor": fd}))
    # (4 + 40 + 36) us over 10 ops x 4 ranks
    assert read("frontdoor_host_us.allreduce_large", v) == 2.0


def test_frontdoor_offcpu_keeps_the_allreduce_phases_alone():
    spans = []
    for k in range(5):                       # 5 ops on each of 4 rank threads
        for r in range(4):
            t = 10 * MS * k + r
            # rank 0 folds: its launch blocks 2 us off the CPU on the card's queue
            wait = ("fold", 2000, 0) if r == 0 else ("rendezvous", 3000, 100)
            spans += [span("allreduce", t, t + 5000, 3000, rank=r, thread=r),
                      span("enter", t, t + 1000, 500, rank=r, thread=r, depth=1),
                      span(wait[0], t + 1000, t + 1000 + wait[1], wait[2], rank=r,
                           thread=r, depth=1),
                      span("copy", t + 4000, t + 5000, 1000, rank=r, thread=r, depth=1)]
    # a Barrier's phases between the windows' ops are not the Allreduce's
    spans += [span("barrier", 99 * MS, 99 * MS + 10**5, 0, thread=0),
              span("enter", 99 * MS, 99 * MS + 10**5, 0, thread=0, depth=1)]
    v = view(facts(), spans, ops=5)
    # off the CPU per rank-op: enter 500 ns + copy 0; the fold's wait on the
    # card and the rendezvous are left out
    assert read("frontdoor_offcpu_us.allreduce_large", v) == 0.5


def test_ddp_counters_per_step():
    train = {"steps": 8, "step_ns": 8 * 400 * MS, "wait_ns": 8 * 13 * MS,
             "pack_ns": 8 * 100 * MS, "start_ns": 8 * 7 * MS, "optimizer_ns": 8 * 250 * MS}
    v = view(facts(counters={"train": train}))
    assert read("ddp_pack_ms_per_step", v) == 100.0
    assert read("ddp_optimizer_ms_per_step", v) == 250.0
    # the parent's counters have no such keys: nothing to read
    old = view(facts(counters={"train": {"steps": 8, "step_ns": 1, "wait_ns": 1}}))
    assert read("ddp_pack_ms_per_step", old) is None
    assert read("ddp_optimizer_ms_per_step", old) is None


def test_offcpu_per_rank_step():
    spans = []
    for r in range(4):
        for k in range(2):
            t = k * 1000 * MS
            spans += [span("ddp.pack", t, t + 10 * MS, 4 * MS, rank=r, thread=r, depth=1),
                      span("ddp.start", t + 10 * MS, t + 11 * MS, MS, rank=r, thread=r,
                           depth=1),
                      span("ddp.wait", t + 11 * MS, t + 40 * MS, 0, rank=r, thread=r,
                           depth=1),
                      span("ddp.optimizer", t + 40 * MS, t + 60 * MS, 18 * MS, rank=r,
                           thread=r, depth=1),
                      span("model.forward", t - 300 * MS, t - 100 * MS, 50 * MS, rank=r,
                           thread=r)]
    # spans without a CPU reading are left out of every off-CPU reader
    spans += [span("ddp.pack", 0, 500 * MS, -1, thread=9, depth=1),
              span("model.forward", 0, 500 * MS, -1, thread=9)]
    v = view(facts(), spans, ops=2)
    assert read("ddp_offcpu_ms_per_step", v) == 8.0          # 6 + 0 + 2; not the wait
    assert read("forward_offcpu_ms_per_step.ddp", v) == 150.0


def test_forward_offcpu_reads_nothing_from_the_model_step_s_phase():
    # the sp cell: the step's model.forward phase carries wall time alone
    spans = [span("model.step", 0, 100 * MS, -1, rank=-1),
             span("model.forward", 0, 40 * MS, -1, rank=-1, depth=1)]
    assert read("forward_offcpu_ms_per_step.ddp", view(facts(ranks=1), spans, ops=1)) is None


def test_idle_inside_each_model_phase():
    # two steps of 100 ms: forward 0-40, backward 40-80, grad_sum 80-95, update 95-100
    spans = []
    for k in range(2):
        t = 100 * MS * k
        for name, a, b in (("forward", 0, 40), ("backward", 40, 80), ("grad_sum", 80, 95),
                           ("update", 95, 100)):
            spans.append(span(f"model.{name}", t + a * MS, t + b * MS, 0, rank=-1, depth=1))
        spans.append(span("model.step", t, t + 100 * MS, 0, rank=-1))
    # busy: 30 ms of each forward, the whole backward, nothing after
    busy = [(100 * MS * k + a * MS, 100 * MS * k + b * MS) for k in range(2)
            for a, b in ((5, 35), (40, 80))]
    v = view(facts(ranks=1), spans, ops=2, busy=busy, window=(0, 200 * MS))
    got = {p: read(f"idle_ms_per_step.{p}", v)
           for p in ("forward", "backward", "grad_sum", "update")}
    assert got == {"forward": 10.0, "backward": 0.0, "grad_sum": 15.0, "update": 5.0}
    # the four tile the step: their sum is the window's idle time per step
    assert sum(got.values()) == (200 * MS - sum(b - a for a, b in busy)) / 2 / MS


def test_readers_read_nothing_without_the_program_s_spans():
    v = view(facts())
    for name in ("frontdoor_host_us.allreduce_large", "frontdoor_offcpu_us.allreduce_large",
                 "ddp_pack_ms_per_step", "ddp_optimizer_ms_per_step",
                 "ddp_offcpu_ms_per_step", "forward_offcpu_ms_per_step.ddp",
                 "idle_ms_per_step.forward", "idle_ms_per_step.update"):
        assert read(name, v) is None, name
