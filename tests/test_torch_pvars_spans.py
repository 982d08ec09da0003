"""The span ring of ``tpu_mpi_torch.perfvars`` and the counters beside it:
one clock (``perf_counter_ns``), the front door's phases with ``enter``,
the DDP trainer's and the model step's phases, CPU time over each span,
the ring's bound, and results that do not change with the ring on."""

import time
from collections import Counter

import numpy as np
import pytest
import torch

import tpu_mpi_torch as MPI
from tpu_mpi_torch import config, perfvars, xla
from tpu_mpi_torch.analyze import timeline
from tpu_mpi_torch.models import transformer as tr
from tpu_mpi_torch.parallel import dp
from tpu_mpi_torch.train import DDPTrainer

CPU = torch.device("cpu")
NRANKS = 4
FRONT = ("enter", "rendezvous", "fold", "copy")


@pytest.fixture
def ring():
    """The ring on for one test, off and empty after it."""
    perfvars.spans_on(1 << 16)
    try:
        yield
    finally:
        perfvars.spans_off()
        perfvars.take_spans()


def _allreduce_job(ops, brackets=None):
    """``ops`` Allreduces of float32[64] DeviceBuffers on the CPU, 4 rank
    threads (the benchmark's call, auto-armed after its first calls);
    every rank's results as bytes."""
    out = {}

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(torch.linspace(-1, 1, 64) * (r + 1), device="cpu")
        y = MPI.DeviceBuffer(torch.zeros(64), device="cpu")
        mine, got = [], []
        for _ in range(ops):
            a = time.perf_counter_ns()
            MPI.Allreduce(x, y, MPI.SUM, comm)
            mine.append((a, time.perf_counter_ns()))
            got.append(y.value.numpy().tobytes())
        out[r] = got
        if brackets is not None:
            brackets[r] = mine

    MPI.testing.run_spmd(body, NRANKS, timeout=120)
    return out


def _ops_and_phases(spans):
    """Each rank's op spans, in order, with the phase spans nested in each."""
    by_rank = {}
    for s in spans:
        if s.name == "allreduce":
            by_rank.setdefault(s.rank, []).append((s, []))
    for s in spans:
        if s.name in FRONT:
            for op, phases in by_rank[s.rank]:
                if s.thread == op.thread and op.t0_ns <= s.t0_ns <= op.t1_ns:
                    phases.append(s)
                    break
    return by_rank


def test_ring_is_off_by_default():
    assert perfvars.span_begin() is None
    perfvars.span_end("nothing", None)
    _allreduce_job(3)
    assert perfvars.take_spans() == []


def test_a_raise_inside_a_span_leaves_the_depth_as_it_was(ring):
    cfg, params, _, tokens = _sp_step()
    broken = dict(params, layers=[{} for _ in params["layers"]])
    with pytest.raises(KeyError):
        tr.transformer_forward(cfg, broken, tokens[0])
    outer = perfvars.span_begin()
    perfvars.span_begin()                    # left open, as by a raise
    perfvars.span_end("outer", outer)
    perfvars.span_end("after", perfvars.span_begin())
    got = [(s.name, s.depth) for s in perfvars.take_spans()]
    assert got == [("model.forward", 0), ("model.block", 1), ("outer", 0),
                   ("after", 0)]


def test_allreduce_phases_nest_in_the_op_inside_the_call(ring):
    brackets = {}
    _allreduce_job(20, brackets)
    by_rank = _ops_and_phases(perfvars.take_spans())
    assert sorted(by_rank) == list(range(NRANKS))
    for r, ops in by_rank.items():
        assert len(ops) == 20
        for (op, phases), (a, b) in zip(ops, brackets[r]):
            assert a <= op.t0_ns <= op.t1_ns <= b
            names = [p.name for p in phases]
            assert names[0] == "enter" and names[-1] == "copy", names
            assert names[1] in ("rendezvous", "fold") and len(names) == 3
            assert all(p.depth == op.depth + 1 for p in phases)
            for p, q in zip(phases, phases[1:]):
                assert p.t1_ns <= q.t0_ns
            assert op.t0_ns <= phases[0].t0_ns and phases[-1].t1_ns <= op.t1_ns
            for s in (op, *phases):
                assert 0 <= s.cpu_ns <= s.t1_ns - s.t0_ns


def test_phases_cover_the_ops_wall_time(ring):
    _allreduce_job(200)
    by_rank = _ops_and_phases(perfvars.take_spans())
    wall = sum(op.t1_ns - op.t0_ns for ops in by_rank.values() for op, _ in ops)
    covered = sum(p.t1_ns - p.t0_ns for ops in by_rank.values()
                  for _, phases in ops for p in phases)
    assert sum(len(ops) for ops in by_rank.values()) == 200 * NRANKS
    assert 0.8 * wall <= covered <= wall


def test_frontdoor_totals_add_up():
    perfvars.reset()
    _allreduce_job(30)
    fd = perfvars.frontdoor_totals("allreduce")
    assert fd["ops"] == 30 * NRANKS
    assert fd["auto_hits"] > 0 and fd["auto_arms"] >= NRANKS
    phases = sum(fd[f"{p}_ns"] for p in FRONT)
    assert fd["enter_ns"] > 0 and fd["copy_ns"] > 0
    assert 0.8 * fd["op_ns"] <= phases <= fd["op_ns"]
    assert perfvars.frontdoor_totals("bcast")["ops"] == 0
    # enter stays out of the per-comm schema the stats report renders
    comms = perfvars.snapshot()["comms"]
    assert all("enter" not in c["phase_s"] for c in comms)


def test_phase_s_is_the_per_collective_split_summed():
    perfvars.reset()

    def body():
        comm = MPI.COMM_WORLD
        x = MPI.DeviceBuffer(torch.ones(64), device="cpu")
        y = MPI.DeviceBuffer(torch.zeros(64), device="cpu")
        for _ in range(5):
            MPI.Allreduce(x, y, MPI.SUM, comm)
            MPI.Allgather(torch.ones(4), comm)

    MPI.testing.run_spmd(body, NRANKS, timeout=120)
    comms = perfvars.snapshot()["comms"]
    split = [perfvars.frontdoor_totals(c) for c in ("allreduce", "allgather")]
    assert all(fd["ops"] == 5 * NRANKS for fd in split)
    for p in perfvars.PHASES:
        want = sum(fd[f"{p}_ns"] for fd in split)
        assert sum(c["phase_s"][p] for c in comms) * 1e9 == pytest.approx(want, abs=1)
    assert sum(c["phase_s"]["rendezvous"] + c["phase_s"]["fold"] for c in comms) > 0


def test_cpu_time_and_time_off_the_cpu(ring):
    t = perfvars.span_begin()
    time.sleep(0.05)
    perfvars.span_end("sleep", t)
    t = perfvars.span_begin()
    x = 0
    for i in range(200_000):
        x += i
    perfvars.span_end("spin", t)
    sleep, spin = perfvars.take_spans()
    assert sleep.name == "sleep" and sleep.rank == -1 and sleep.depth == 0
    assert (sleep.t1_ns - sleep.t0_ns) - sleep.cpu_ns >= 40_000_000
    assert 0 < spin.cpu_ns <= spin.t1_ns - spin.t0_ns


def test_spans_without_the_cpu_clock(ring):
    perfvars.span_end("wall", perfvars.span_begin(cpu=False))
    ph = perfvars.Phases("outer")
    ph.lap("a")
    ph.close()
    assert [(s.name, s.cpu_ns) for s in perfvars.take_spans()] == \
        [("wall", -1), ("outer", -1), ("a", -1)]


def test_nested_spans_take_their_depth(ring):
    a = perfvars.span_begin()
    b = perfvars.span_begin()
    perfvars.span_end("inner", b)
    perfvars.span_end("outer", a)
    outer, inner = perfvars.take_spans()
    assert (outer.name, outer.depth, inner.name, inner.depth) == \
        ("outer", 0, "inner", 1)
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns


def test_capacity_drops_the_oldest_and_counts_them():
    perfvars.spans_on(5)
    try:
        for i in range(12):
            perfvars.span_end(f"s{i}", perfvars.span_begin())
        assert perfvars.spans_dropped() == 7
        assert [s.name for s in perfvars.take_spans()] == \
            [f"s{i}" for i in range(7, 12)]
        assert perfvars.take_spans() == []
    finally:
        perfvars.spans_off()
    perfvars.spans_on(5)
    try:
        assert perfvars.spans_dropped() == 0
    finally:
        perfvars.spans_off()
    with pytest.raises(ValueError):
        perfvars.spans_on(0)


def test_spans_off_keeps_what_the_ring_holds():
    perfvars.spans_on(8)
    t = perfvars.span_begin()
    perfvars.spans_off()
    perfvars.span_end("after_off", t)
    perfvars.spans_on(8)
    perfvars.span_end("kept", perfvars.span_begin())
    perfvars.spans_off()
    assert perfvars.span_begin() is None
    assert [s.name for s in perfvars.take_spans()] == ["kept"]


def _ddp_job(steps):
    """A small DDP run on 4 rank threads; every rank's final masters."""
    rng = np.random.default_rng(7)
    spec = {f"p{i}": rng.standard_normal(n)
            for i, n in enumerate((300, 50, 400, 120, 10, 256))}
    out = {}

    def body():
        comm = MPI.COMM_WORLD
        r = comm.rank()
        trainer = DDPTrainer(spec, comm, bucket_bytes=1024, device="cpu")
        for s in range(steps):
            g = np.random.default_rng(10_000 * s + r)
            grads = {n: torch.from_numpy(g.standard_normal(a.size))
                     for n, a in spec.items()}
            trainer.step((n, grads[n]) for n in reversed(list(spec)))
        out[r] = {n: p.numpy().tobytes() for n, p in trainer.params.items()}

    MPI.testing.run_spmd(body, NRANKS, timeout=120)
    return out


def test_ddp_phases_add_up_to_the_step(ring):
    before = perfvars.train_snapshot()
    _ddp_job(6)
    after = perfvars.train_snapshot()
    d = {k: after.get(k, 0) - before.get(k, 0)
         for k in ("steps", "step_ns", "pack_ns", "start_ns", "wait_ns",
                   "optimizer_ns", "bucket_flushes", "starts", "waits")}
    assert d["steps"] == 6 * NRANKS
    parts = d["pack_ns"] + d["start_ns"] + d["wait_ns"] + d["optimizer_ns"]
    assert 0.8 * d["step_ns"] <= parts <= d["step_ns"]
    assert d["starts"] == d["waits"] == d["bucket_flushes"] > 0
    spans = perfvars.take_spans()
    steps = [s for s in spans if s.name == "ddp.step"]
    assert len(steps) == 6 * NRANKS
    n = Counter(s.name for s in spans)
    buckets = d["bucket_flushes"]
    assert n["ddp.pack"] == n["ddp.start"] == n["ddp.wait"] == buckets
    assert n["ddp.optimizer"] == 6 * NRANKS
    for step in steps:
        inner = [s for s in spans if s.thread == step.thread
                 and step.t0_ns <= s.t0_ns <= step.t1_ns
                 and s.name in ("ddp.pack", "ddp.start", "ddp.wait",
                                "ddp.optimizer")]
        assert inner and all(s.depth == step.depth + 1 for s in inner)
        assert all(s.t1_ns <= step.t1_ns for s in inner)


def _sp_step():
    cfg = tr.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                               d_ff=64, max_seq=16, dtype=torch.float32)
    params = tr.transformer_init(torch.Generator().manual_seed(0), cfg, device=CPU)
    step, _ = tr.transformer_train_step(
        cfg, xla.make_mesh({"sp": 4}, devices=[CPU]), lr=1e-2)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 64, (3, 2, 16), generator=g)
    return cfg, params, step, tokens


def _sp_run(params, step, tokens):
    losses = []
    for s in range(len(tokens) - 1):
        params, loss = step(params, tokens[s], tokens[s + 1])
        losses.append(float(loss))
    return [p.numpy().tobytes() for p in dp.leaves(params)], losses


def test_model_step_phases_tile_the_step(ring):
    cfg, params, step, tokens = _sp_step()
    before = perfvars.model_snapshot()
    _sp_run(params, step, tokens)
    after = perfvars.model_snapshot()
    d = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert d["steps"] == 2
    assert d["forward_ns"] + d["backward_ns"] + d["grad_sum_ns"] \
        + d["update_ns"] == d["step_ns"]
    spans = perfvars.take_spans()
    steps = [s for s in spans if s.name == "model.step"]
    assert len(steps) == 2
    order = ("model.forward", "model.backward", "model.grad_sum", "model.update")
    for st in steps:
        inside = [s for s in spans if st.t0_ns <= s.t0_ns <= st.t1_ns]
        phases = [s for s in inside if s.depth == st.depth + 1
                  and s.name in order]
        assert [p.name for p in phases] == list(order)
        assert phases[0].t0_ns == st.t0_ns and phases[-1].t1_ns == st.t1_ns
        assert all(a.t1_ns == b.t0_ns for a, b in zip(phases, phases[1:]))
        assert all(s.cpu_ns == -1 for s in inside)
        n = Counter(s.name for s in inside)
        assert n["attend_along"] == n["model.block"] == cfg.n_layers
        assert n["attend_along.backward"] == cfg.n_layers
        assert n["xla.allreduce"] >= len(dp.leaves(params))


def test_forward_records_its_span(ring):
    cfg, params, _, tokens = _sp_step()
    tr.transformer_forward(cfg, params, tokens[0])
    n = Counter(s.name for s in perfvars.take_spans())
    assert n["model.forward"] == 1 and n["model.block"] == cfg.n_layers


def test_results_bit_for_bit_with_the_ring_on_and_off():
    cfg, params, step, tokens = _sp_step()
    off = (_allreduce_job(10), _ddp_job(3), _sp_run(params, step, tokens))
    perfvars.spans_on(1 << 16)
    try:
        on = (_allreduce_job(10), _ddp_job(3), _sp_run(params, step, tokens))
    finally:
        perfvars.spans_off()
        assert perfvars.take_spans()
    assert on == off


def test_snapshot_carries_the_model_and_kernels_blocks():
    snap = perfvars.snapshot()
    assert "model" in snap
    k = snap["kernels"]
    names = set(k["builds"])
    assert {"fused_reduce", "ring", "permute", "ring_attention",
            "ring_attention_sm90"} <= names
    assert set(k["build_ns"]) == set(k["loads"]) == set(k["load_ns"]) == names
    for key in ("fold_launches", "attention_launches", "chained_folds",
                "layout_copies", "callable_rings"):
        assert isinstance(k[key], int)
    # one level of nesting at most: a window's difference is key by key
    assert all(not isinstance(v, dict) for d in k.values()
               if isinstance(d, dict) for v in d.values())


def test_timeline_renders_ring_records(ring):
    _allreduce_job(2)
    spans = perfvars.take_spans()
    t = perfvars.span_begin()
    perfvars.span_end("outside", t)
    spans += perfvars.take_spans()
    rec = timeline.to_chrome([], ring=spans)
    slices = [e for e in rec["traceEvents"] if e.get("cat") == "ring"]
    assert len(slices) == len(spans)
    assert {e["pid"] for e in slices} == set(range(NRANKS)) | {timeline.OUTSIDE_RANKS}
    assert min(e["ts"] for e in slices) == 0
    timed = [e for e in slices if "cpu_us" in e["args"]]
    assert len(timed) == sum(s.cpu_ns >= 0 for s in spans) > 0
    assert all(e["args"]["cpu_us"] <= e["dur"] + 0.001 for e in timed)
    lanes = {e["pid"]: e["args"]["name"] for e in rec["traceEvents"]
             if e.get("name") == "process_name"}
    assert lanes[timeline.OUTSIDE_RANKS] == "outside ranks"
