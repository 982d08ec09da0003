"""Operations and bytes of the Moonlight cell's work, from its shapes, held
against the card's peaks (``counts``)."""

from __future__ import annotations

from .counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, causal_pairs


def forward_flops(cfg: dict, rows: int, seq: int) -> int:
    """Matrix-multiply FLOPs of one forward pass over ``rows`` sequences of
    ``seq`` tokens, two a multiply-add: per layer the latent attention's
    four projections, its scores (q/k head dim nope + rope) and
    probabilities times values (v head dim) at the causal pairs only, then
    the dense layers' SwiGLU, or the router, the ``top_k`` experts a token
    uses (the active ones only) and the shared SwiGLU; the untied head."""
    d, h, L, v = cfg["d_model"], cfg["n_heads"], cfg["n_layers"], cfg["vocab"]
    qk, dv, kv = cfg["qk_nope"] + cfg["qk_rope"], cfg["v_head"], cfg["kv_rank"]
    tokens = rows * seq
    proj = 2 * tokens * (d * h * qk + d * (kv + cfg["qk_rope"])
                         + kv * h * (cfg["qk_nope"] + dv) + h * dv * d)
    attn = 2 * rows * h * causal_pairs(seq) * (qk + dv)
    dense = 2 * tokens * 3 * d * cfg["d_ff"]
    moe = 2 * tokens * (d * cfg["n_experts"]
                        + 3 * d * cfg["d_expert"] * (cfg["top_k"] + cfg["n_shared"]))
    n_moe = L - cfg["n_dense"]
    return L * (proj + attn) + cfg["n_dense"] * dense + n_moe * moe + 2 * tokens * d * v


def step_flops(cfg: dict, rows: int, seq: int) -> int:
    """FLOPs of one train step: the forward and a backward of twice its
    work."""
    return 3 * forward_flops(cfg, rows, seq)


def attention_least_s(bh: int, t: int, dq: int, dv: int) -> float:
    """The least time of one latent-attention launch of ``bh`` batch-heads
    over a causal sequence of t: the larger of its operations (q.k at head
    dim dq and p.v at dv, over the causal pairs) at the bf16 peak and its
    bytes (q and k, v and the output, bfloat16, each once) at the HBM peak."""
    flops = 2 * bh * causal_pairs(t) * (dq + dv)
    nbytes = 2 * bh * t * (2 * dq + 2 * dv)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def alltoall_least_s(rows: int, d: int, itemsize: int = 2) -> float:
    """The least time of one exchange of ``rows`` routed rows of width d:
    each row's bytes read once and written once at the HBM peak (padding
    not counted, whatever moves it)."""
    return 2 * rows * d * itemsize / PEAK_HBM_BYTES
