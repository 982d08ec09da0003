"""The references against plain PyTorch written another way, on the CPU at
a tiny size."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference import flagship as ref
from portbench.reference.fold import rank_ordered_sum

CFG = {"vocab": 40, "d_model": 16, "n_heads": 2, "n_layers": 2, "d_ff": 24, "seq": 8}


def test_rank_ordered_sum_is_the_left_fold():
    xs = inputs.operands(7, 4, [1001], torch.float32, torch.device("cpu"))[0]
    acc = np.zeros(1001, dtype=np.float32)
    acc += xs[0].numpy()
    for x in xs[1:]:
        acc = (acc + x.numpy()).astype(np.float32)
    assert np.array_equal(rank_ordered_sum(xs).numpy(), acc)
    # a sum in another order differs somewhere at this size
    assert not torch.equal(rank_ordered_sum(xs[::-1]), rank_ordered_sum(xs))


def test_control_fold_rounds_to_bfloat16():
    xs = inputs.operands(8, 4, [512], torch.float32, torch.device("cpu"))[0]
    got = rank_ordered_sum(xs, compute=torch.bfloat16)
    assert got.dtype == torch.float32
    assert torch.equal(got, got.bfloat16().float())
    assert not torch.equal(got, rank_ordered_sum(xs))


def other_forward(w, tokens):
    """The same block through other PyTorch calls, in float64: complex
    rotary embeddings, SDPA with its causal mask, cross-entropy."""
    b, t = tokens.shape
    h, d = CFG["n_heads"], CFG["d_model"]
    dh = d // h

    def norm(x, s):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * s

    half = dh // 2
    theta = 10000.0 ** (-torch.arange(half, dtype=torch.float64) / half)
    rot = torch.polar(torch.ones(t, half, dtype=torch.float64),
                      torch.arange(t, dtype=torch.float64)[:, None] * theta)

    def rope(x):
        z = torch.complex(x[..., :half], x[..., half:]) * rot
        return torch.cat([z.real, z.imag], -1)

    x = w["embed"][tokens]
    for i in range(CFG["n_layers"]):
        p = f"layers.{i}."
        qkv = norm(x, w[p + "ln1"]) @ w[p + "w_qkv"]
        q, k, v = qkv.view(b, t, h, 3, dh).permute(3, 0, 2, 1, 4)
        o = F.scaled_dot_product_attention(rope(q), rope(k), v, is_causal=True)
        x = x + o.transpose(1, 2).reshape(b, t, d) @ w[p + "w_proj"]
        y = norm(x, w[p + "ln2"]) @ w[p + "w_in"]
        gelu = 0.5 * y * (1 + torch.tanh(math.sqrt(2 / math.pi) * (y + 0.044715 * y ** 3)))
        x = x + gelu @ w[p + "w_out"]
    return norm(x, w["ln_f"]) @ w["embed"].t()


def weights():
    w = inputs.flagship_weights(3, CFG, torch.float32, torch.device("cpu"))
    for k in w:
        if w[k].dim() == 1:
            w[k] = w[k] + 0.1 * torch.randn(w[k].shape, generator=torch.Generator().manual_seed(1))
    return w


def test_forward_and_loss_against_another_formulation():
    w = weights()
    tokens, labels = inputs.token_batches(5, 1, 3, CFG["seq"], CFG["vocab"], torch.device("cpu"))
    got = ref.forward(CFG, {k: v.double() for k, v in w.items()}, tokens[0])
    want = other_forward({k: v.double() for k, v in w.items()}, tokens[0])
    # the reference takes its rotary angles in float32, as the model does
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    loss = ref.xent(got, labels[0])
    assert abs(float(loss) - float(F.cross_entropy(want.reshape(-1, CFG["vocab"]),
                                                  labels[0].reshape(-1)))) < 1e-6


def test_sgd_steps_follow_autograd_of_the_shard_losses():
    w = inputs.flagship_weights(4, CFG, torch.float32, torch.device("cpu"))
    tokens, labels = inputs.token_batches(6, 2, 4, CFG["seq"], CFG["vocab"], torch.device("cpu"))
    rec = ref.sgd_steps(CFG, w, tokens, labels, lr=0.5, shards=2, steps=2,
                        store=torch.float32, block_rows=1)
    leaves = {k: v.double().requires_grad_() for k, v in w.items()}
    logits = other_forward(leaves, tokens[0])
    half = CFG["seq"] // 2
    total = sum(F.cross_entropy(logits[:, s:s + half].reshape(-1, CFG["vocab"]),
                                labels[0][:, s:s + half].reshape(-1)) for s in (0, half))
    grads = torch.autograd.grad(total, list(leaves.values()))
    assert rec["losses"][0][0] == pytest.approx(float(total.detach()) / 2, rel=1e-5)
    for (k, _), g in zip(leaves.items(), grads):
        assert rec["grad"][k] == pytest.approx(float(g.double().norm()), rel=1e-4)
        assert rec["grad1"][0][k] == pytest.approx(float(g.double().norm()), rel=1e-3)


def test_ddp_steps_average_the_ranks_and_keep_momentum():
    w = inputs.flagship_weights(9, CFG, torch.float32, torch.device("cpu"))
    tokens, labels = inputs.token_batches(10, 2, 4, CFG["seq"], CFG["vocab"], torch.device("cpu"))
    lr, mu = 0.1, 0.9
    rec = ref.ddp_steps(CFG, w, tokens, labels, ranks=2, lr=lr, momentum=mu, steps=2)
    p = {k: v.double() for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    for s in range(2):
        gs = []
        for r in range(2):
            leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
            loss = F.cross_entropy(other_forward(leaves, tokens[s, 2 * r:2 * r + 2])
                                   .reshape(-1, CFG["vocab"]),
                                   labels[s, 2 * r:2 * r + 2].reshape(-1))
            assert rec["losses"][s][r] == pytest.approx(float(loss.detach()), rel=1e-5)
            gs.append(torch.autograd.grad(loss, list(leaves.values())))
        for i, k in enumerate(p):
            m[k] = mu * m[k] + (gs[0][i].double() + gs[1][i].double()) / 2
            p[k] = p[k] - lr * m[k]
    for k in p:
        assert rec["change"][0][k] == pytest.approx(float((p[k] - w[k].double()).norm()), rel=1e-4)
        assert rec["change"][1][k] == rec["change"][0][k]


def test_fp8_control_rounds_the_products():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(2))
    q = ref.fp8(x)
    assert not torch.equal(q, x)
    assert float((q - x).abs().max()) <= float(x.abs().max()) * 2 ** -3
