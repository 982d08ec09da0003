"""The Moonlight cell's inputs, made from its seed: the weights and the
token batches, on the run's device (``inputs`` has the streams and the
generator; this file adds what only this cell draws).

Token ids follow a Zipf law over the whole vocabulary: the id of rank r
(1-based) comes with probability proportional to ``r ** -s``, and which id
has which rank is a seeded permutation. A few ids then make much of the
text, as in real text, and the router sends their rows to the same experts.
"""

from __future__ import annotations

import numpy as np
import torch

from .inputs import STREAM_ORDER, STREAM_TOKENS, STREAM_WEIGHTS, generator

BIAS_SCALE = 0.01       # the selection bias: normal(0, 1) times this


def shapes(cfg: dict) -> list:
    """(name, shape, scale) of every weight in forward order: a scale of
    None is a norm's ones, ``"bias"`` the router's selection bias. The
    names are the port's (``tpu_mpi_torch.models.moonlight``)."""
    d, h, L, v = cfg["d_model"], cfg["n_heads"], cfg["n_layers"], cfg["vocab"]
    E, f, fs = cfg["n_experts"], cfg["d_expert"], cfg["n_shared"] * cfg["d_expert"]
    qk, kv = cfg["qk_nope"] + cfg["qk_rope"], cfg["kv_rank"]
    deep = (2 * L) ** -0.5
    out = [("embed", (v, d), 1.0)]
    for i in range(L):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), None), (p + "w_q", (d, h * qk), d ** -0.5),
                (p + "w_kva", (d, kv + cfg["qk_rope"]), d ** -0.5),
                (p + "ln_kv", (kv,), None),
                (p + "w_kvb", (kv, h * (cfg["qk_nope"] + cfg["v_head"])), kv ** -0.5),
                (p + "w_o", (h * cfg["v_head"], d), (h * cfg["v_head"]) ** -0.5 * deep),
                (p + "ln2", (d,), None)]
        if i < cfg["n_dense"]:
            out += [(p + "w_gate", (d, cfg["d_ff"]), d ** -0.5),
                    (p + "w_up", (d, cfg["d_ff"]), d ** -0.5),
                    (p + "w_down", (cfg["d_ff"], d), cfg["d_ff"] ** -0.5 * deep)]
        else:
            out += [(p + "w_router", (d, E), d ** -0.5), (p + "bias", (E,), "bias"),
                    (p + "e_gate", (E, d, f), d ** -0.5), (p + "e_up", (E, d, f), d ** -0.5),
                    (p + "e_down", (E, f, d), f ** -0.5 * deep),
                    (p + "s_gate", (d, fs), d ** -0.5), (p + "s_up", (d, fs), d ** -0.5),
                    (p + "s_down", (fs, d), fs ** -0.5 * deep)]
    out += [("ln_f", (d,), None), ("head", (d, v), d ** -0.5)]
    return out


def weights(seed: int, cfg: dict, dtype: torch.dtype, device: torch.device) -> dict:
    """The weights by name: normal(0, 1) times each one's scale, drawn in
    float32 tensor by tensor from one generator and cast to ``dtype``; norms
    are ones, the selection bias stays float32."""
    gen = generator(seed, STREAM_WEIGHTS, device)
    out = {}
    for name, shape, scale in shapes(cfg):
        if scale is None:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        out[name] = w.mul_(BIAS_SCALE) if scale == "bias" else w.mul_(scale).to(dtype)
        del w
    return out


def zipf_batches(seed: int, steps: int, rows: int, seq: int, vocab: int, s: float,
                 device: torch.device) -> tuple:
    """``steps`` batches of ``rows`` sequences of Zipf-distributed ids:
    tokens (steps, rows, seq) and labels, the same sequences one position
    on, both contiguous int64. A reference that needs the first batches
    draws them at the same ``steps`` and slices."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64) ** -s
    cdf = torch.from_numpy(np.cumsum(ranks) / ranks.sum()).to(device)
    order = torch.randperm(vocab, generator=generator(seed, STREAM_ORDER, device),
                           device=device)
    u = torch.rand((steps, rows, seq + 1), generator=generator(seed, STREAM_TOKENS, device),
                   dtype=torch.float64, device=device)
    seqs = order[torch.searchsorted(cdf, u).clamp_(max=vocab - 1)]
    return seqs[..., :seq].contiguous(), seqs[..., 1:].contiguous()
