"""Operations and bytes the cells' work needs, from their shapes, and the
card's published peaks they are held against.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit.
A card set below that limit runs slower; ``PERF.md`` gives each reading's
power limit beside it.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES = 3.35e12        # HBM3 bytes/s


def fold_bytes(ranks: int, nbytes: int) -> int:
    """Bytes an Allreduce's fold must move on one card: every rank's operand
    read once and the result written once."""
    return (ranks + 1) * nbytes


def fold_least_s(ranks: int, nbytes: int) -> float:
    """The least time the fold can take: its bytes at the HBM peak (the
    operations, ranks - 1 adds an element, are far below the compute peak)."""
    return fold_bytes(ranks, nbytes) / PEAK_HBM_BYTES


def causal_pairs(t: int) -> int:
    """(query, key) pairs a causal mask keeps in a sequence of t."""
    return t * (t + 1) // 2


def flagship_forward_flops(cfg: dict, rows: int, seq: int) -> int:
    """Matrix-multiply FLOPs of one forward pass over ``rows`` sequences of
    ``seq`` tokens: per layer the qkv, output and two FFN projections, the
    scores and the probabilities times the values at the causal pairs only,
    then the tied output projection to the vocabulary. Two FLOPs a
    multiply-add."""
    d, f, L, v = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], cfg["vocab"]
    tokens = rows * seq
    proj = 2 * tokens * d * (3 * d) + 2 * tokens * d * d + 2 * 2 * tokens * d * f
    attn = 2 * 2 * rows * causal_pairs(seq) * d       # q.k and p.v, all heads
    return L * (proj + attn) + 2 * tokens * d * v


def flagship_step_flops(cfg: dict, rows: int, seq: int) -> int:
    """FLOPs of one train step: the forward and a backward of twice its
    work."""
    return 3 * flagship_forward_flops(cfg, rows, seq)
