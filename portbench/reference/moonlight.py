"""Moonlight-16B-A3B's equations (DeepSeek-V3's block) in plain PyTorch, for
judging the port's expert-parallel train step. Written from the model's
description (the DeepSeek-V2/V3 papers and the Hugging Face ``deepseek_v3``
modelling file); it imports nothing of tpu_mpi_torch.

The block, per token, pre-norm (RMSNorm, eps ``eps``) around each part:
multi-head latent attention (``q = y W_q`` cut per head into nope + rope
columns, ``[c; k_r] = y W_kva``, ``c = RMSNorm(c) g_kv`` with eps 1e-6,
``[k_n; v] = c W_kvb`` per head, rotary embeddings on ``q_r`` and on the one
``k_r`` the heads share, causal softmax of ``q.k / sqrt(nope + rope)`` times
``v``, the heads concatenated times ``W_o``); then in the first ``n_dense``
layers a SwiGLU FFN, in the others the sigmoid router (float32 scores, the
top k of scores plus the selection bias, weights ``scale * s_i / sum s``),
the weighted routed SwiGLU experts and a shared SwiGLU; a final RMSNorm,
the untied head and the mean next-token cross-entropy.

Departures from the published model, none of which random weights can see
or which the port shares:

- rotary embeddings of the half-split form (rotate-half over the first and
  second halves of the 64 rotary columns), where the HF code pairs columns
  (2i, 2i+1) first: a fixed permutation of those columns;
- plain SGD in place of the model's own optimizer;
- the sequence-wise balance loss and the update of the selection bias are
  left out of the step (the bias is fixed, drawn from the seed).

The reference computes in float32 with TF32 off, one sequence at a time:
routing is dropless, so no token's output depends on another sequence's
routing, and the sum of the sequences' gradients is the batch's. Attention
and the loss run over blocks of query rows, each recomputed in the backward
(``torch.utils.checkpoint``), so that a 4096-token sequence fits the card
beside the float32 weights and gradients. ``quant`` and ``fault`` are as in
``reference.flagship``; ``capacity_drop``, the fault of the routed layer,
lets each sequence send an expert at most its mean load (``T k / E`` rows,
rounded up), the first in token order, and drops the rest.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .flagship import exact_matmul, fp8  # noqa: F401  (fp8: the control's quant)

FAULTS = ("half_batch", "no_exchange", "altered", "capacity_drop")
ALTERED_LEAF = "layers.0.w_up"      # the leaf whose gradient "altered" doubles
BLOCK_ROWS = 1024                   # query rows of an attention or loss block

# configuration-file keys (the source's names) -> the names used here
SIZES = {"vocab": "vocab_size", "d_model": "hidden_size", "n_heads": "num_attention_heads",
         "n_layers": "num_hidden_layers", "n_dense": "first_k_dense_replace",
         "d_ff": "intermediate_size", "kv_rank": "kv_lora_rank",
         "qk_nope": "qk_nope_head_dim", "qk_rope": "qk_rope_head_dim",
         "v_head": "v_head_dim", "n_experts": "n_routed_experts",
         "top_k": "num_experts_per_tok", "d_expert": "moe_intermediate_size",
         "n_shared": "n_shared_experts"}
FLOATS = {"routed_scale": "routed_scaling_factor", "rope_base": "rope_theta",
          "eps": "rms_norm_eps"}


def model_cfg(config: dict) -> dict:
    """The sizes this file and the benchmark use, from a configuration file."""
    out = {k: int(config[v]) for k, v in SIZES.items()}
    out.update({k: float(config[v]) for k, v in FLOATS.items()})
    return out


def is_bias(name: str) -> bool:
    return name.endswith(".bias")


def is_expert(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("e_gate", "e_up", "e_down")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, base: float) -> torch.Tensor:
    """Half-split rotary embeddings of x (..., T, r) at positions 0 .. T-1."""
    half = x.shape[-1] // 2
    freqs = 1.0 / torch.pow(base, torch.arange(half, dtype=torch.float32,
                                               device=x.device) / half)
    ang = torch.arange(x.shape[-2], device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention_rows(mm, q, k, v, lo: int, hi: int) -> torch.Tensor:
    """Causal attention of query rows lo .. hi-1 of one sequence: q, k
    (h, T, dq), v (h, T, dv)."""
    s = mm(q[:, lo:hi], k[:, :hi].transpose(-1, -2)) / math.sqrt(q.shape[-1])
    keep = torch.ones(hi - lo, hi, dtype=torch.bool, device=q.device).tril(lo)
    att = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return mm(att, v[:, :hi])


def route(scores: torch.Tensor, bias: torch.Tensor, k: int, scale: float) -> tuple:
    """The top k of scores + bias (of equal values the lower expert first)
    and their weights ``scale * s_i / sum s_chosen``."""
    order = torch.sort(scores.detach() + bias, dim=-1, descending=True, stable=True).indices
    idx = order[:, :k]
    return idx, weigh(scores, idx, scale)


def weigh(scores: torch.Tensor, idx: torch.Tensor, scale: float) -> torch.Tensor:
    """The weights ``scale * s_i / sum s_chosen`` of the chosen experts."""
    picked = scores.gather(-1, idx)
    return picked / (picked.sum(-1, keepdim=True) + 1e-20) * scale


def hidden(cfg: dict, w: dict, tokens: torch.Tensor, quant: Optional[Callable] = None,
           fault: Optional[str] = None, routes: Optional[list] = None,
           replay: Optional[list] = None, keys: Optional[list] = None) -> torch.Tensor:
    """The final-normed rows (T, d) of one sequence of tokens (T,) under the
    float32 weights ``w``; ``routes`` collects each MoE layer's own choice of
    experts (T, k) and ``keys`` what it chose by, the scores plus the bias
    (T, E). ``replay``, one (T, k) a MoE layer, makes the layer run those
    experts in place of its own choice, weighted by its own scores."""
    def mm(a, b):
        return quant(a) @ quant(b) if quant is not None else a @ b

    def swiglu(y, g, u, dn):
        return mm(F.silu(mm(y, g)) * mm(y, u), dn)

    T = tokens.shape[0]
    h, nope, rope_d, dv = cfg["n_heads"], cfg["qk_nope"], cfg["qk_rope"], cfg["v_head"]
    eps = cfg["eps"]
    x = w["embed"][tokens]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        y = rms_norm(x, w[p + "ln1"], eps)
        q = mm(y, w[p + "w_q"]).view(T, h, nope + rope_d).transpose(0, 1)
        c, k_r = mm(y, w[p + "w_kva"]).split([cfg["kv_rank"], rope_d], -1)
        c = rms_norm(c, w[p + "ln_kv"], 1e-6)
        k_n, v = mm(c, w[p + "w_kvb"]).view(T, h, nope + dv).transpose(0, 1).split(
            [nope, dv], -1)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg["rope_base"])], -1)
        k = torch.cat([k_n, rope(k_r, cfg["rope_base"]).expand(h, T, rope_d)], -1)
        o = torch.cat([checkpoint(_attention_rows, mm, q, k, v, lo, min(T, lo + BLOCK_ROWS),
                                  use_reentrant=False)
                       for lo in range(0, T, BLOCK_ROWS)], dim=1)
        x = x + mm(o.transpose(0, 1).reshape(T, h * dv), w[p + "w_o"])
        y = rms_norm(x, w[p + "ln2"], eps)
        if i < cfg["n_dense"]:
            x = x + swiglu(y, w[p + "w_gate"], w[p + "w_up"], w[p + "w_down"])
            continue
        scores = torch.sigmoid(mm(y, w[p + "w_router"]))
        idx, weights = route(scores, w[p + "bias"], cfg["top_k"], cfg["routed_scale"])
        if routes is not None:
            routes.append(idx)
        if keys is not None:
            keys.append(scores.detach() + w[p + "bias"])
        if replay is not None:
            idx = replay[i - cfg["n_dense"]].to(idx.device)
            weights = weigh(scores, idx, cfg["routed_scale"])
        cap = math.ceil(T * cfg["top_k"] / cfg["n_experts"])
        out = torch.zeros_like(y)
        for e in range(cfg["n_experts"]):
            rows, slot = (idx == e).nonzero(as_tuple=True)     # in token order
            if fault == "capacity_drop":
                rows, slot = rows[:cap], slot[:cap]
            if rows.numel():
                got = swiglu(y[rows], w[p + "e_gate"][e], w[p + "e_up"][e], w[p + "e_down"][e])
                out = out.index_add(0, rows, got * weights[rows, slot, None])
        x = x + out + swiglu(y, w[p + "s_gate"], w[p + "s_up"], w[p + "s_down"])
    return rms_norm(x, w["ln_f"], eps)


def _loss_rows(mm, hid, head, labels):
    logp = torch.log_softmax(mm(hid, head), dim=-1)
    return -logp.gather(-1, labels[:, None]).sum()


def loss(cfg: dict, w: dict, tokens: torch.Tensor, labels: torch.Tensor,
         quant: Optional[Callable] = None, fault: Optional[str] = None,
         routes: Optional[list] = None, replay: Optional[list] = None,
         keys: Optional[list] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence, the head in blocks of
    rows; ``half_batch`` keeps the first half of its tokens."""
    def mm(a, b):
        return quant(a) @ quant(b) if quant is not None else a @ b

    hid = hidden(cfg, w, tokens, quant, fault, routes, replay, keys)
    T = tokens.shape[0] // 2 if fault == "half_batch" else tokens.shape[0]
    total = sum(checkpoint(_loss_rows, mm, hid[lo:lo + BLOCK_ROWS], w["head"],
                           labels[lo:lo + BLOCK_ROWS], use_reentrant=False)
                for lo in range(0, T, BLOCK_ROWS))
    return total / T


def _norms(tensors: dict) -> dict:
    return {k: float(t.double().norm()) for k, t in tensors.items()}


def sgd_steps(cfg: dict, init: dict, tokens, labels, *, lr: float, ranks: int, steps: int,
              store: torch.dtype, quant=None, fault=None, routes: Optional[list] = None,
              replay: Optional[list] = None, keys: Optional[list] = None) -> dict:
    """The expert-parallel train step's arithmetic, ``steps`` times: rank r
    holds sequences ``r * b .. (r + 1) * b - 1`` of each (B, T) batch (b = B /
    ranks) and its loss is their tokens' mean; the gradient of the ranks'
    sum, then ``p - lr * g`` rounded to ``store``. The selection bias takes
    no gradient and no update. ``no_exchange`` gives the weights every rank
    holds rank 0's gradient alone (the routed experts keep everyone's).
    ``tokens`` and ``labels`` are (steps, B, T).

    Returns what ``reference.flagship.sgd_steps`` returns, by leaf (the bias
    left out), and with ``routes`` a list, fills it with the first step's
    own choices of experts, by sequence then MoE layer. ``replay``, in the
    same form, makes the first step run those experts instead (the program's
    choices: bfloat16 and float32 scores can order near-equal experts
    differently, and a flipped choice moves a router's gradient far more
    than rounding does; ``routes`` then holds what the reference would have
    chosen on the same inputs). ``keys``, a list, is filled in the same
    form with what that step's choices were made by (the scores plus the
    bias, (T, E) a MoE layer)."""
    B = tokens.shape[1]
    per = B // ranks
    names = [k for k in init if not is_bias(k)]
    p = {k: v.float() for k, v in init.items()}
    losses, rec = [], {}
    with exact_matmul():
        for s in range(steps):
            leaves = {k: p[k].detach().requires_grad_() for k in names}
            w = {**p, **leaves}
            acc = {k: torch.zeros_like(p[k]) for k in names}
            total = 0.0
            for j in range(B):
                got = [] if routes is not None and s == 0 else None
                by = [] if keys is not None and s == 0 else None
                given = replay[j] if replay is not None and s == 0 else None
                ell = loss(cfg, w, tokens[s, j], labels[s, j], quant, fault, got, given,
                           by) / per
                if got is not None:
                    routes.append(got)
                if by is not None:
                    keys.append(by)
                gs = torch.autograd.grad(ell, [leaves[k] for k in names])
                for k, g in zip(names, gs):
                    if fault != "no_exchange" or j < per or is_expert(k):
                        acc[k] += g
                total += float(ell.detach())
                del ell, gs
            losses.append([total / ranks])
            if fault == "altered":
                acc[ALTERED_LEAF] *= 2
            if s == 0:
                rec["grad"] = _norms(acc)
            del leaves, w
            for k in names:
                p[k] = (p[k] - lr * acc.pop(k)).to(store).float()
            if s == 0:
                rec["grad1"] = [{k: float(((init[k].double() - p[k].double()) / lr).norm())
                                 for k in names}]
    rec["losses"] = losses
    rec["change"] = [{k: float((p[k].double() - init[k].double()).norm()) for k in names}]
    return rec
