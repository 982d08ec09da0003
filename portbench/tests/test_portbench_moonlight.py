"""The Moonlight cell on the CPU at a tiny size: a sound run is correct, each
fault planted in the program makes it incorrect, the control and the
reference's faults read over the limits, the counts and readers give known
answers, and a run loads no JAX. The tiny block keeps the cell's shape (a
dense layer, then MoE layers, latent attention with q/k wider than v) in
float32, where a sound run reads near zero."""

import json
import math
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from portbench import control_moonlight as control
from portbench import counts_moonlight as counts
from portbench import harness, inputs_moonlight
from portbench.check import verdict
from portbench.drivers import moe_train
from portbench.reference import moonlight as ref

CELL = "moonlight.ep4.b4x4096"
CPU = torch.device("cpu")
SEED = 2 ** 32 + 17
MANIFEST = harness.load_json(ROOT / "BENCHMARK.json")
TINY = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, kv_lora_rank=32, n_routed_experts=16, num_experts_per_tok=4,
            moe_intermediate_size=24, intermediate_size=96, vocab_size=96,
            num_hidden_layers=3, dtype="float32")


def tiny() -> dict:
    _, _, config, traffic = control.cell_files(CELL)
    config.update(TINY)
    traffic.update(seq=16, batches=6)
    return {"config": config, "traffic": traffic}


def run(trace=False):
    return harness.run_cell(MANIFEST, ROOT, CELL, SEED, 0.3, trace, CPU, **tiny())


def test_sound_tiny_run_is_correct():
    res, err, counters = run()
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert any("route flips" in line for line in err)
    assert res["checks"]["route_miss_share"]["value"] == 0
    assert res["checks"]["route_weight_gap"]["value"] < 1e-6
    res, _, counters = run(trace=True)
    assert counters["model"]["moe_layers"] > 0
    assert res["metrics"]["moe_load_max_over_mean"]["value"] >= 1.0
    assert res["metrics"]["train_step_mfu.moonlight"]["value"] > 0


@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_planted_in_the_program_is_caught(fault):
    with control.plant(fault):
        res, _, _ = run()
    assert res["correct"] is False, (fault, res["checks"])


def test_control_and_reference_faults_read_over_the_limits():
    limits = harness.load_json(ROOT / "portbench" / "workloads" / f"{CELL}.json")["limits"]
    readings = control.train_readings(CELL, SEED, CPU, **tiny())
    assert set(readings) == {"control"} | set(ref.FAULTS)
    for name, numbers in readings.items():
        ok, _ = verdict(numbers, limits)
        assert not ok, (name, numbers)


def test_capacity_fault_keeps_the_first_rows_in_token_order():
    idx = torch.tensor([[[0, 1], [0, 2], [0, 1], [3, 0]]])          # (1, 4, 2), E 4
    kept = control._kept(idx, 4)                                     # cap 2 a rank
    assert kept.tolist() == [[[True, True], [True, True], [False, True], [True, False]]]


def test_run_loads_no_jax():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
            f"sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r}); "
            "from test_portbench_moonlight import run; run(); "
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tpu_mpi_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "tpu_mpi"} & loaded


def test_weights_are_the_ports_shapes_and_the_batches_zipf():
    from tpu_mpi_torch.models import moonlight as ml
    m = ref.model_cfg({**control.cell_files(CELL)[2], **TINY})
    pcfg = moe_train.program_cfg(ml, m, torch.float32)
    want = [(name, shape) for name, shape, _ in ml.moonlight_shapes(pcfg)]
    assert [(name, shape) for name, shape, _ in inputs_moonlight.shapes(m)] == want
    w = inputs_moonlight.weights(5, m, torch.bfloat16, CPU)
    assert w["layers.1.bias"].dtype == torch.float32 and w["embed"].dtype == torch.bfloat16
    assert torch.equal(w["embed"], inputs_moonlight.weights(5, m, torch.bfloat16, CPU)["embed"])
    tokens, labels = inputs_moonlight.zipf_batches(5, 3, 2, 4096, 1000, 1.0, CPU)
    assert torch.equal(tokens[..., 1:], labels[..., :-1])
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 1000
    top = torch.bincount(tokens.flatten(), minlength=1000).max().item() / tokens.numel()
    assert 0.08 < top < 0.2              # 1 / H(1000) = 0.134 for the commonest id


def test_flip_share_counts_sets_not_orders():
    prog = [torch.tensor([[[0, 1], [2, 3]], [[1, 0], [3, 2]]])]        # (n 2, t 2, k 2)
    refs = [[torch.tensor([[1, 0], [2, 3]])], [torch.tensor([[0, 1], [3, 1]])]]
    seqs = moe_train.by_sequence(prog, 2, 1)
    assert torch.equal(seqs[1][0], prog[0][1])
    assert moe_train.flip_share(seqs, refs) == 0.25


def test_replayed_routes_change_the_choice_and_not_the_weights():
    m = ref.model_cfg({**control.cell_files(CELL)[2], **TINY})
    w = {k: v.float() for k, v in inputs_moonlight.weights(3, m, torch.float32, CPU).items()}
    tokens = torch.randint(0, m["vocab"], (16,), generator=torch.Generator().manual_seed(3))
    own = []
    base = ref.hidden(m, w, tokens, routes=own)
    again, mine = [], []
    assert torch.equal(ref.hidden(m, w, tokens, routes=mine, replay=own), base)
    swapped = [r.roll(1, -1) for r in own]                   # the same sets, other order
    assert torch.allclose(ref.hidden(m, w, tokens, replay=swapped), base, atol=1e-6)
    other = [(r + 1) % m["n_experts"] for r in own]
    assert not torch.allclose(ref.hidden(m, w, tokens, routes=again, replay=other), base)
    assert torch.equal(again[0], own[0])        # the first MoE layer's own choice stands


def test_step_flops_by_hand():
    m = dict(vocab=10, d_model=4, n_heads=2, n_layers=2, n_dense=1, d_ff=6, kv_rank=3,
             qk_nope=2, qk_rope=2, v_head=2, n_experts=4, top_k=2, d_expert=5, n_shared=1)
    rows, t = 1, 3
    tokens = rows * t
    proj = 2 * tokens * (4 * 2 * 4 + 4 * (3 + 2) + 3 * 2 * (2 + 2) + 2 * 2 * 4)
    attn = 2 * rows * 2 * 6 * (4 + 2)                # 6 causal pairs of 3
    dense = 2 * tokens * 3 * 4 * 6
    moe = 2 * tokens * (4 * 4 + 3 * 4 * 5 * (2 + 1))
    head = 2 * tokens * 4 * 10
    want = 2 * (proj + attn) + dense + moe + head
    assert counts.forward_flops(m, rows, t) == want
    assert counts.step_flops(m, rows, t) == 3 * want
    full = ref.model_cfg(control.cell_files(CELL)[2])
    assert 78.9e12 < counts.step_flops(full, 4, 4096) < 79.0e12


def test_bounds_at_the_cell_shape():
    assert abs(counts.attention_least_s(64, 4096, 192, 128) * 1e3 - 0.34750) < 1e-4
    assert abs(counts.alltoall_least_s(98304, 2048) * 1e3 - 0.24039) < 1e-4


class _View:
    def __init__(self, counters, spans=(), busy=(), ops=2, window=(0, 100)):
        self.facts = harness.Facts(attempted=ops, failed=0, ops=ops, window=(0, 1), setup_s=0,
                                   memory_peak_bytes=0, numbers={}, counters=counters)
        self.ops, self.has_trace, self.window = ops, True, window
        self.busy, self.rank0_spans = list(busy), list(spans)


def test_readers_give_known_answers():
    least_a = counts.attention_least_s(64, 4096, 192, 128) * 1e3
    least_x = counts.alltoall_least_s(98304, 2048) * 1e3
    c = {"device_ms": {"void sm90::ring_attention_sm90_kernel<192, 128, 3>(x)": 4 * least_a,
                       "void alltoall_kernel<uint4>(y)": 8 * least_x},
         "device_launches": {"void sm90::ring_attention_sm90_kernel<192, 128, 3>(x)": 2,
                             "void alltoall_kernel<uint4>(y)": 4},
         "shapes": {"attention": [64, 4096, 192, 128], "routed_rows": 98304, "d_model": 2048},
         "model": {"moe_layers": 4, "moe_routed_rows": 4 * 6400, "moe_expert_slots": 4 * 64,
                   "moe_rows_max": 4 * 200}}
    spans = [("train_step", 0, 5), ("model.mla", 10, 20), ("model.moe.route", 20, 30),
             ("model.moe.experts", 40, 60), ("model.backward", 60, 90)]
    v = _View(c, spans=spans, busy=[(0, 25), (50, 100)])
    read = harness.metric_reader
    assert math.isclose(read("attention_roofline.moonlight")(v), 50.0)
    assert math.isclose(read("alltoall_roofline.moonlight")(v), 50.0)
    assert math.isclose(read("moe_load_max_over_mean")(v), 2.0)
    assert read("moe_card_ms_per_step")(v) is None
    assert read("attention_roofline.moonlight")(_View({})) is None
    moe = {**c, "moe_device_ms": 30.0, "unmatched_device_ms": 0.0}
    assert math.isclose(read("moe_card_ms_per_step")(_View(moe)), 15.0)
    unmatched = {**moe, "unmatched_device_ms": 0.02 * sum(c["device_ms"].values())}
    assert read("moe_card_ms_per_step")(_View(unmatched)) is None


class _Event:
    def __init__(self, cid, where, start, dur=0):
        self.cid, self.where, self.start, self.dur = cid, where, start, dur

    def correlation_id(self):
        return self.cid

    def device_type(self):
        return "DeviceType." + self.where

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur


def test_device_time_goes_to_the_span_open_at_its_launch():
    """A kernel counts for the span open when its runtime call began, on
    whatever clock, however late it runs, clipped to the window; one whose
    call the trace lacks is counted apart."""
    off = 1000
    events = [_Event(1, "CPU", off + 15), _Event(1, "CUDA", 40, 10),    # launched in, runs after
              _Event(2, "CPU", off + 25), _Event(2, "CUDA", 50, 10),    # launched outside
              _Event(3, "CPU", off + 31), _Event(3, "CUDA", 95, 20),    # in; clipped to 100
              _Event(4, "CUDA", 60, 5)]                                 # no call
    ms, unmatched = moe_train.launched_in(events, [(10, 20), (30, 35)], off, (0, 100))
    assert (ms, unmatched) == ((10 + 5) / 1e6, 5 / 1e6)


def test_miss_share_excuses_what_the_score_gap_can_explain():
    want = torch.tensor([[0.9, 0.8, 0.5, 0.1], [0.9, 0.8, 0.5, 0.1]])  # (T 2, E 4)
    near = want + torch.tensor([[0.0, -0.2, 0.2, 0.0], [0.0, 0.0, 0.0, 0.0]])
    top = near.topk(2).indices                       # token 0 picks {0, 2}: explained
    assert moe_train.miss_share([[top]], [[near]], [[want]]) == 0.0
    wrong = torch.tensor([[0, 2], [0, 3]])           # token 1 by nothing near its keys
    assert moe_train.miss_share([[wrong]], [[near]], [[want]]) == 0.5


def test_weight_gap_reads_the_weights_against_the_scores():
    scores = torch.tensor([[[0.6, 0.2, 0.4]]])
    idx = torch.tensor([[[0, 2]]])
    w = torch.tensor([[[0.6, 0.4]]]) * 2.0
    assert moe_train.weight_gap([(idx, None, scores, w)], 2.0) < 1e-7
    assert math.isclose(moe_train.weight_gap([(idx, None, scores, w * 1.01)], 2.0), 0.01,
                        rel_tol=1e-5)
