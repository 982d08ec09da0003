"""The FLOP and byte counts against hand sums at a small size."""

from portbench import counts

SMALL = {"vocab": 10, "d_model": 4, "n_heads": 2, "n_layers": 3, "d_ff": 8}


def test_fold_bytes():
    assert counts.fold_bytes(4, 1 << 28) == 5 * (1 << 28)
    assert abs(counts.fold_least_s(4, 1 << 28) * 1e3 - 0.40065) < 1e-4


def test_causal_pairs():
    assert counts.causal_pairs(1) == 1
    assert counts.causal_pairs(4) == 4 + 3 + 2 + 1


def test_forward_flops_by_hand():
    rows, t = 2, 3
    tokens = rows * t                                   # 6
    qkv = 2 * tokens * 4 * 12                           # 576
    proj = 2 * tokens * 4 * 4                           # 192
    ffn = 2 * (2 * tokens * 4 * 8)                      # 768
    # q.k and p.v over the pairs a causal mask keeps: 6 a row of 3
    attn = 2 * (2 * rows * 6 * 4)                       # 384
    head = 2 * tokens * 4 * 10                          # 480
    want = 3 * (qkv + proj + ffn + attn) + head         # 6240
    assert counts.flagship_forward_flops(SMALL, rows, t) == want
    assert counts.flagship_step_flops(SMALL, rows, t) == 3 * want


def test_flagship_step_at_its_size():
    flagship = {"vocab": 32768, "d_model": 1024, "n_heads": 16, "n_layers": 8, "d_ff": 4096}
    got = counts.flagship_step_flops(flagship, 8, 1024)
    assert 7.00e12 < got < 7.02e12          # 7.4e12 with attention unmasked
