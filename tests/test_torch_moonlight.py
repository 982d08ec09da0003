"""Moonlight's block on the port (tpu_mpi_torch.models.moonlight) against the
benchmark's plain reference (portbench/reference/moonlight.py), and the
pieces it added: attention with a v head dim of its own and the
query-blocked backward, top-k routing, the dropless top-k dispatch and the
chunked loss. On the CPU at a tiny size."""

import math

import pytest
import torch

from portbench.reference import moonlight as ref
from tpu_mpi_torch import perfvars, xla
from tpu_mpi_torch.kernels import attention
from tpu_mpi_torch.models import moonlight as ml
from tpu_mpi_torch.parallel import ep

CPU = torch.device("cpu")
SIZES = dict(vocab=96, d_model=64, n_heads=4, n_layers=3, n_dense=1, d_ff=96, kv_rank=32,
             qk_nope=16, qk_rope=8, v_head=16, n_experts=16, top_k=4, d_expert=24,
             n_shared=2)
CFG = ml.MoonlightConfig(**SIZES, loss_rows=8, dtype=torch.float32)
REF = dict(SIZES, routed_scale=CFG.routed_scale, rope_base=CFG.rope_base, eps=CFG.eps)


def _batch(seed, rows=4, t=16):
    g = torch.Generator().manual_seed(seed)
    params = ml.moonlight_init(g, CFG, device="cpu")
    tokens = torch.randint(0, CFG.vocab, (rows, t), generator=g)
    return params, tokens, tokens.roll(-1, 1)


def _mesh(n):
    return xla.make_mesh({"ep": n}, devices=[CPU])


@pytest.mark.parametrize("n", [4, 1])
def test_step_matches_the_reference_loss_and_every_gradient(n):
    params, tokens, labels = _batch(3)
    step = ml.moonlight_train_step(CFG, _mesh(n), lr=1.0)
    new, loss = step(params, tokens, labels)
    routes = []
    rec = ref.sgd_steps(REF, params, tokens[None], labels[None], lr=1.0, ranks=n, steps=1,
                        store=torch.float32, routes=routes)
    assert abs(float(loss) - rec["losses"][0][0]) <= 1e-5 * abs(rec["losses"][0][0])
    assert set(rec["grad"]) == {k for k in params if not k.endswith(".bias")}
    for k, want in rec["grad"].items():
        got = (params[k].double() - new[k].double())      # lr 1: the gradient
        assert abs(float(got.norm()) - want) <= 1e-4 * want + 1e-7, k
    for k in params:
        if k.endswith(".bias"):
            assert torch.equal(new[k], params[k])       # no gradient, no update
    assert len(routes) == tokens.shape[0] and len(routes[0]) == CFG.n_layers - CFG.n_dense


def test_step_gradients_elementwise_against_autograd_of_the_reference():
    params, tokens, labels = _batch(5)
    new, _ = ml.moonlight_train_step(CFG, _mesh(4), lr=1.0)(params, tokens, labels)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()
              if not k.endswith(".bias")}
    w = {**params, **leaves}
    total = sum(ref.loss(REF, w, tokens[j], labels[j]) for j in range(4))
    grads = torch.autograd.grad(total, list(leaves.values()))
    for (k, leaf), want in zip(leaves.items(), grads):
        got = params[k] - new[k]
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale + 1e-6, k


def test_forward_is_the_reference_forward():
    params, tokens, _ = _batch(7, rows=2)
    logits = ml.moonlight_forward(CFG, params, tokens)
    for j in range(2):
        want = ref.hidden(REF, params, tokens[j]) @ params["head"]
        torch.testing.assert_close(logits[j], want, atol=1e-5, rtol=1e-5)


def test_step_runs_with_pvars_and_counts_no_dropped_row(monkeypatch):
    params, tokens, labels = _batch(9)
    monkeypatch.setattr(perfvars, "enabled", lambda: True)
    before = perfvars.model_snapshot()
    ml.moonlight_train_step(CFG, _mesh(4), lr=1e-2)(params, tokens, labels)
    after = perfvars.model_snapshot()
    d = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    layers = CFG.n_layers - CFG.n_dense
    assert d["moe_layers"] == layers and d["steps"] == 1
    assert d["moe_routed_rows"] == layers * tokens.numel() * CFG.top_k
    assert d["moe_exchanged_rows"] >= 2 * d["moe_routed_rows"]
    assert d["moe_rows_max"] * CFG.n_experts >= d["moe_routed_rows"]


def test_each_moe_layer_backward_is_a_span_of_its_own():
    """With the ring on, each MoE layer's backward is one span, the layers'
    in reverse order and apart, inside the step's backward; with it off
    the step registers no span."""
    params, tokens, labels = _batch(10)
    step = ml.moonlight_train_step(CFG, _mesh(4), lr=1e-2)
    perfvars.spans_on(4096)
    try:
        step(params, tokens, labels)
    finally:
        perfvars.spans_off()
    spans = perfvars.take_spans()
    back = [s for s in spans if s.name == "model.moe.backward"]
    fwd = [s for s in spans if s.name == "model.moe.route"]
    (whole,) = [s for s in spans if s.name == "model.backward"]
    assert len(back) == len(fwd) == CFG.n_layers - CFG.n_dense
    assert all(whole.t0_ns <= s.t0_ns <= s.t1_ns <= whole.t1_ns for s in back)
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(back, back[1:]))
    step(params, tokens, labels)
    assert not perfvars.take_spans()


# ---------------------------------------------------------------------------
# Attention at q/k and v head dims of their own
# ---------------------------------------------------------------------------

def _dense_attention(q, k, v, causal, scale):
    """float64 softmax attention over the gathered (BH, n t, d) sequence."""
    n, bh, t, _ = q.shape
    glob = lambda x: x.double().transpose(0, 1).reshape(bh, n * t, x.shape[-1])  # noqa: E731
    s = glob(q) @ glob(k).transpose(1, 2) * scale
    if causal:
        s = s.masked_fill(torch.ones(n * t, n * t, dtype=torch.bool).triu(1), -math.inf)
    o = torch.softmax(s, -1) @ glob(v)
    return o.view(bh, n, t, -1).transpose(0, 1)


@pytest.mark.parametrize("n,t,dq,dv,causal", [(1, 40, 24, 16, True), (3, 16, 24, 8, True),
                                              (2, 24, 16, 24, False)])
def test_plain_attention_takes_a_v_head_dim_of_its_own(n, t, dq, dv, causal):
    g = torch.Generator().manual_seed(n * t + dq)
    q, k = (torch.randn(n, 3, t, dq, generator=g) for _ in range(2))
    v = torch.randn(n, 3, t, dv, generator=g)
    got = attention.attend(q, k, v, causal=causal)
    assert got.shape == (n, 3, t, dv)
    want = _dense_attention(q, k, v, causal, dq ** -0.5)
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block_bytes", [1 << 30, 3 * 4 * 64 * 96])
@pytest.mark.parametrize("n,causal", [(1, True), (2, True), (2, False)])
def test_query_blocked_backward_matches_autograd(monkeypatch, block_bytes, n, causal):
    """The backward against autograd of a dense float64 softmax, in one
    block a rank and in 64-row blocks (a budget of 64 rows of 96 keys at 3
    batch-heads: the least block, 64 rows, at these t)."""
    monkeypatch.setattr(attention, "BACKWARD_BLOCK_BYTES", block_bytes)
    t, dq, dv = 96 if n > 1 else 160, 24, 16
    g = torch.Generator().manual_seed(11 * n + causal)
    q, k = (torch.randn(n, 3, t, dq, generator=g) for _ in range(2))
    v = torch.randn(n, 3, t, dv, generator=g)
    dout = torch.randn(n, 3, t, dv, generator=g)
    scale = dq ** -0.5
    rows = attention.backward_rows(3, t, n * t)
    assert rows == t if block_bytes == 1 << 30 else rows == 64
    o = attention.attend(q, k, v, causal=causal)
    got = attention.attention_backward(q, k, v, o, dout, causal=causal, scale=scale)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(_dense_attention(*leaves, causal, scale), leaves, dout.double())
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a.double(), b, atol=2e-5, rtol=2e-5)


def test_backward_rows_bounds_the_scores():
    assert attention.backward_rows(128, 256, 1024) == 256         # the flagship: one block
    rows = attention.backward_rows(64, 4096, 4096)                 # Moonlight's layer
    assert rows == 1024 and 4 * 64 * rows * 4096 <= attention.BACKWARD_BLOCK_BYTES
    assert attention.backward_rows(1 << 20, 4096, 1 << 20) == 64   # at least one tile


def test_sm90_route_takes_latent_attention_dims():
    assert attention.sm90_takes(192, 128) and attention.sm90_takes(64, 64)
    assert attention.route(torch.bfloat16, 192, True, 128) == "sm90"
    assert attention.route(torch.bfloat16, 64, True) == "sm90"
    for d, dv in ((192, 64), (200, 128), (256, 128), (128, 64), (136, 136)):
        assert not attention.sm90_takes(d, dv), (d, dv)
    assert attention.route(torch.bfloat16, 192, False, 128) == "mma_sync"


# ---------------------------------------------------------------------------
# Routing, dispatch and the loss
# ---------------------------------------------------------------------------

def test_routing_selects_by_biased_score_and_weighs_by_score_with_ties():
    scores = torch.tensor([[0.9, 0.1, 0.5, 0.5, 0.2, 0.5]])
    bias = torch.tensor([0.0, 0.75, 0.0, 0.0, 0.0, 0.0])
    idx, w = ml.route(scores, bias, 3, 2.0)
    # s + b: 0.9, 0.85, 0.5, 0.5, 0.2, 0.5: of the three 0.5s the lowest expert
    assert idx.tolist() == [[0, 1, 2]]
    want = torch.tensor([[0.9, 0.1, 0.5]]) / 1.5 * 2.0
    torch.testing.assert_close(w, want)
    ridx, rw = ref.route(scores, bias, 3, 2.0)
    assert torch.equal(ridx, idx) and torch.allclose(rw, w)
    # the gradient reaches the scores, not the bias
    s = scores.clone().requires_grad_()
    b = bias.clone().requires_grad_()
    ml.route(s, b, 3, 2.0)[1].sum().backward()
    assert s.grad is not None and b.grad is None


def _identity_experts(scale_by_expert):
    def run(rows, segments):
        out, lo = [], 0
        for e, c in enumerate(segments):
            out.append(rows[lo:lo + c] * scale_by_expert[e])
            lo += c
        return torch.cat(out)
    return run


def test_dropless_dispatch_when_every_token_routes_to_one_rank():
    """Every row of every rank goes to experts 2 and 3, both on rank 1: one
    block of the exchange holds all of a rank's rows, and none is lost."""
    n, t, k, d, E = 4, 10, 3, 5, 8
    g = torch.Generator().manual_seed(2)
    tokens = torch.randn(n, t, d, generator=g)
    even = torch.arange(t) % 2 == 0
    idx = torch.stack([torch.where(even, 3, 2), torch.full((t,), 3), torch.where(even, 2, 3)],
                      -1).expand(n, t, k).clone()
    weights = torch.rand(n, t, k, generator=g)
    scale = torch.arange(1.0, E + 1)
    routing = ep.TopkRouting(idx, E)
    assert routing.capacity == t * k and sum(routing.segments) == n * t * k
    assert routing.segments == [0, 0, int((idx == 2).sum()), int((idx == 3).sum())] + [0] * 4
    got = ep.moe_topk_dispatch_combine(tokens, idx, weights, _identity_experts(scale),
                                       routing=routing)
    want = (tokens[:, :, None, :] * scale[idx][..., None] * weights[..., None]).sum(2)
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_dispatch_is_exact_at_any_routing(seed):
    n, t, k, d, E = 4, 12, 4, 6, 16
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randn(n, t, d, generator=g, requires_grad=True)
    idx = torch.stack([torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(t)])
                       for _ in range(n)])
    if seed == 2:                                         # a crowd on one expert
        idx[..., 0] = 5
    weights = torch.rand(n, t, k, generator=g, requires_grad=True)
    scale = torch.rand(E, generator=g) + 0.5
    r = ep.TopkRouting(idx, E)
    got = ep.moe_topk_dispatch_combine(tokens, idx, weights, _identity_experts(scale),
                                       routing=r)
    want = (tokens[:, :, None, :] * scale[idx][..., None] * weights[..., None]).sum(2)
    torch.testing.assert_close(got, want)
    cot = torch.randn(n, t, d, generator=g)
    ga = torch.autograd.grad(got, [tokens, weights], cot)
    gb = torch.autograd.grad(want, [tokens, weights], cot)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b)
    assert sum(r.segments) == n * t * k
    assert int(r.loads.sum()) == n * t * k and r.exchanged_rows == n * n * r.capacity


def test_topk_dispatch_refuses_experts_that_do_not_divide():
    with pytest.raises(ValueError):
        ep.TopkRouting(torch.zeros(4, 2, 1, dtype=torch.int64), 6)


@pytest.mark.parametrize("rows", [16, 5, 64])
def test_chunked_loss_and_gradients_match_whole_logits(rows):
    n, T, d, V = 3, 16, 8, 40
    g = torch.Generator().manual_seed(rows)
    y = torch.randn(n, T, d, generator=g, requires_grad=True)
    w0 = torch.randn(d, V, generator=g)
    w = w0.expand(n, d, V).detach().requires_grad_()
    labels = torch.randint(0, V, (n, T), generator=g)
    got = ml.chunked_xent(y, w, labels, rows)
    logp = torch.log_softmax(torch.matmul(y, w), -1)
    want = -logp.gather(-1, labels[..., None])[..., 0].mean(-1)
    torch.testing.assert_close(got, want)
    cot = torch.tensor([1.0, 0.5, 2.0])
    ga = torch.autograd.grad(got, [y, w], cot)
    gb = torch.autograd.grad(want, [y, w], cot)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_step_refuses_meshes_it_does_not_take():
    with pytest.raises(ValueError):
        ml.moonlight_train_step(CFG, xla.make_mesh({"ep": 2, "dp": 2}, devices=[CPU]))
    with pytest.raises(ValueError):
        ml.moonlight_train_step(CFG, xla.make_mesh({"ep": 3}, devices=[CPU]))


def test_shapes_count_the_published_parameters():
    full = ml.MoonlightConfig(n_layers=5)
    total = sum(math.prod(s) for name, s, _ in ml.moonlight_shapes(full))
    assert 3.09e9 < total < 3.10e9
    experts = sum(math.prod(s) for name, s, _ in ml.moonlight_shapes(full) if ml.is_expert(name))
    assert experts == 4 * 64 * 3 * 2048 * 1408
