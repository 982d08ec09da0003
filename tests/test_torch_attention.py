"""The port's ring attention (tpu_mpi_torch.kernels.attention) against the
Pallas kernel it replaces (tpu_mpi.xla.pallas_kernels.ring_attention),
which runs here in interpret mode on the conftest's 8-device CPU mesh, as
tests/test_pallas_kernels.py runs it.

The same numpy inputs, made from a seed, go through both: the JAX kernel
under shard_map with in_specs=P("x") (each rank a (t_local, d) block), the
port's wrapper on the stacked (n, t_local, d) CPU tensors, where it runs
its plain version, the TPU kernel's schedule replayed. Tolerance: float32,
atol 1e-5 — the same schedule, with the two libraries' matmul and exp.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from tpu_mpi import xla as jxla
from tpu_mpi.xla import pallas_kernels as pk
from tpu_mpi_torch.kernels import attention
from tpu_mpi_torch.kernels._build import counts

# (n, t_local, d, causal)
CASES = [(4, 8, 16, True), (4, 8, 16, False), (8, 8, 16, True)]


def _inputs(case):
    n, t, d, _ = case
    rng = np.random.default_rng(CASES.index(case) + 500)
    return [rng.standard_normal((n, t, d)).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_results(n: int) -> dict:
    cases = [c for c in CASES if c[0] == n]
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    mesh = jxla.make_mesh({"x": n})

    def body(*vs):
        return tuple(pk.ring_attention(*vs[3 * i:3 * i + 3], axis="x",
                                       causal=c[3])
                     for i, c in enumerate(cases))

    specs = tuple(P("x") for _ in range(3 * len(cases)))
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                              out_specs=tuple(P("x") for _ in cases),
                              check_vma=False))
    args = [jnp.asarray(a.reshape(-1, a.shape[-1]))
            for c in cases for a in _inputs(c)]
    return {c: np.asarray(out).reshape(c[0], c[1], c[2])
            for c, out in zip(cases, f(*args))}


def _dense(q, k, v, causal, scale, drop=None):
    """float64 attention over the gathered sequence, stacked back; the keys
    at the global positions ``drop`` are left out."""
    n, bh, t, d = q.shape
    g = [x.permute(1, 0, 2, 3).reshape(bh, n * t, d).double() for x in (q, k, v)]
    s = g[0] @ g[1].transpose(-1, -2) * scale
    if causal:
        s = s.masked_fill(~torch.ones(n * t, n * t, dtype=torch.bool).tril(),
                          -math.inf)
    if drop is not None:
        s[..., drop] = -math.inf
    o = torch.softmax(s, -1) @ g[2]
    return o.reshape(bh, n, t, d).permute(1, 0, 2, 3)


@pytest.mark.parametrize("case", CASES, ids=["n{}-t{}-d{}-causal{}".format(*c)
                                              for c in CASES])
def test_plain_matches_pallas_kernel(case):
    want = _jax_results(case[0])[case]
    q, k, v = (torch.from_numpy(a) for a in _inputs(case))
    got = attention.ring_attention(q, k, v, causal=case[3])
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,bh,t,d,causal", [
    (1, 3, 72, 8, True),          # one rank
    (2, 1, 1100, 8, True),        # t > 1024: 512-row panels and a tail panel
    (3, 2, 13, 40, False),        # ragged t and d (any t below the wrapper)
    (4, 2, 8, 128, True),
])
def test_plain_is_exact_attention(n, bh, t, d, causal):
    g = torch.Generator().manual_seed(n * t + d)
    q, k, v = (torch.randn(n, bh, t, d, generator=g) for _ in range(3))
    got = attention.attend(q, k, v, causal=causal)
    want = _dense(q, k, v, causal, d ** -0.5)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


def test_future_blocks_are_exact_no_ops():
    # Under the causal mask rank 0 sees only its own block: its steps over
    # blocks n-1 .. 1 are wholly masked panels, which must leave its state
    # unchanged bit for bit (what lets the kernel skip them).
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(4, 2, 16, 8, generator=g) for _ in range(3))
    ring = attention.attend(q, k, v, causal=True)
    alone = attention.attend(q[:1], k[:1], v[:1], causal=True)
    assert torch.equal(ring[:1], alone)


def test_bfloat16_rounds_p_and_output_to_the_input_dtype():
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(2, 2, 8, 16, generator=g).to(torch.bfloat16)
               for _ in range(3))
    got = attention.attend(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    want = _dense(q.float(), k.float(), v.float(), True, 0.25)
    # one bfloat16 ulp of the output plus the rounding of P
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16_bound_takes_other_rounding_and_rejects_a_dropped_key_tile(causal):
    # allowed_error is the card's bound for the kernel against the plain
    # version. An exact attention rounded once to bfloat16 (P unrounded)
    # stays inside it; one that leaves out a 32-key tile of rank 1's block,
    # as a kernel skipping part of a ring step would, does not.
    g = torch.Generator().manual_seed(10)
    n, bh, t, d = 4, 2, 64, 16
    q, k, v = (torch.randn(n, bh, t, d, generator=g).to(torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    want = attention.attend(q, k, v, causal=causal)
    limit = attention.allowed_error(q, k, v, want, causal=causal, scale=scale)
    assert float(limit.mean()) < 1e-2
    exact = _dense(q.float(), k.float(), v.float(), causal, scale)
    assert bool(((exact.to(torch.bfloat16).float() - want.float()).abs()
                 <= limit).all())
    dropped = _dense(q.float(), k.float(), v.float(), causal, scale,
                     drop=slice(t, t + 32)).to(torch.bfloat16)
    assert not bool(((dropped.float() - want.float()).abs() <= limit).all())


def test_wrapper_shapes_and_refusals():
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(2, 16, 8, generator=g) for _ in range(3))
    three = attention.ring_attention(q, k, v, causal=True)
    four = attention.ring_attention(q[:, None], k[:, None], v[:, None],
                                    causal=True)
    assert three.shape == (2, 16, 8) and torch.equal(three, four[:, 0])
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.ring_attention(q[:, :12], k[:, :12], v[:, :12])
    with pytest.raises(ValueError):
        attention.attend(q[:, None], k[:, None, :8], v[:, None], causal=True)
    with pytest.raises(ValueError):
        attention.attend(q[:, None], k[:, None].double(), v[:, None], causal=True)
    with pytest.raises(TypeError):
        attention.attend(q.numpy(), k, v, causal=True)


def test_cpu_tensors_launch_nothing_and_bounds_count_pairs():
    counts.reset()
    q = torch.randn(2, 1, 8, 8)
    attention.attend(q, q, q, causal=True)
    assert counts["attention_launches"] == 0
    assert attention.causal_pairs(4, 256) == 1024 * 1025 // 2
    assert attention.panel_rows(1024) == 1024 and attention.panel_rows(2048) == 512


def test_library_path_keyed_by_source():
    p = attention.LIBRARY.path()
    assert p.name.startswith("ring_attention-") and p.suffix == ".so"


# The sm90 kernel's arithmetic (tpu_mpi_torch/csrc/ring_attention_sm90.cu),
# replayed here: key tiles of 64 keys in ring-step order, each with its own
# running max, m in log2 units, p = exp2(s * scale * log2(e) - m), the row sum
# of the unrounded p, P rounded to bfloat16 before P.V, out = acc / l. Fully
# masked tiles (the causal skips) are exact no-ops here as in the kernel.

SM90_BLOCK_KEYS = 64


def _sm90_tiling(q, k, v, *, causal, scale):
    n, bh, t, d = q.shape
    f32 = torch.float32
    c = torch.tensor(scale, dtype=f32) * torch.tensor(math.log2(math.e), dtype=f32)
    acc = torch.zeros(q.shape, dtype=f32)
    m = torch.full((n, bh, t, 1), attention.M_INIT, dtype=f32)
    l = torch.zeros((n, bh, t, 1), dtype=f32)
    ranks = torch.arange(n).view(n, 1, 1, 1)
    rows = torch.arange(t).view(1, 1, t, 1)
    qf = q.float()
    for step in range(n):
        src = (ranks - step) % n                 # the block rank r holds
        kc, vc = k.roll(step, 0).float(), v.roll(step, 0).float()
        for k0 in range(0, t, SM90_BLOCK_KEYS):
            ks = slice(k0, min(k0 + SM90_BLOCK_KEYS, t))
            keys = torch.arange(ks.start, ks.stop).view(1, 1, 1, -1)
            s = qf @ kc[:, :, ks].transpose(-1, -2)
            if causal:
                s = s.masked_fill(src * t + keys > ranks * t + rows, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s * c - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(torch.bfloat16).float() @ vc[:, :, ks]
            m = m_new
    return (acc / l).to(q.dtype)


@pytest.mark.parametrize("n,bh,t,d,causal", [
    (4, 2, 72, 64, True),          # ragged t: the last 64-key tile is partial
    (4, 2, 72, 64, False),
    (3, 2, 13, 40, True),          # t below one tile, d below one panel
    (2, 1, 13, 8, False),
    (2, 1, 200, 128, True),        # several tiles a block, two 64-column panels
])
def test_sm90_tiling_stays_inside_the_bfloat16_bound(n, bh, t, d, causal):
    g = torch.Generator().manual_seed(n * t + d + SM90_BLOCK_KEYS)
    q, k, v = (torch.randn(n, bh, t, d, generator=g).to(torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    want = attention.attend(q, k, v, causal=causal)
    limit = attention.allowed_error(q, k, v, want, causal=causal, scale=scale)
    got = _sm90_tiling(q, k, v, causal=causal, scale=scale)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= limit).all()), float((diff / limit).max())
    # the tiling is a real change of rounding, not the plain schedule again
    if t > SM90_BLOCK_KEYS:
        assert not torch.equal(got, want)


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 64, True, "sm90"),          # every model-path call
    (torch.bfloat16, 8, True, "sm90"),
    (torch.bfloat16, 128, True, "sm90"),
    (torch.bfloat16, 36, True, "mma_sync"),      # d % 8 != 0: no tensor map
    (torch.bfloat16, 64, False, "mma_sync"),     # a base off 16 bytes
    (torch.float32, 64, True, "fma"),            # TF32 wgmma would miss 1e-4
    (torch.float32, 36, False, "fma"),
])
def test_route_by_dtype_head_dim_and_alignment(dtype, d, aligned, want):
    assert attention.route(dtype, d, aligned) == want
    assert want in attention.ROUTES


def test_route_counts_reset_with_the_total():
    counts.add("attention_route_launches", "sm90")
    assert counts["attention_launches"] == 1
    counts.reset()
    assert counts["attention_launches"] == 0
    assert counts["attention_route_launches"] == dict.fromkeys(attention.ROUTES, 0)
    assert attention.LIBRARY_SM90.path().name.startswith("ring_attention_sm90-")


# The backward's route (kernels/attention.py:backward_route): the sm90
# kernel for bfloat16 CUDA calls at the sm90 head dims with aligned,
# contiguous operands and the forward's log-sum-exp saved; the plain
# attention_backward for every other call.

@pytest.mark.parametrize("dtype,d,dv,aligned,on_card,lse,want", [
    (torch.bfloat16, 64, 64, True, True, True, "sm90"),       # the flagship's sp step
    (torch.bfloat16, 192, 128, True, True, True, "sm90"),     # Moonlight's latent attention
    (torch.bfloat16, 128, 128, True, True, True, "sm90"),
    (torch.bfloat16, 40, 40, True, True, True, "sm90"),       # padded to a 64-column panel
    (torch.bfloat16, 8, 8, True, True, True, "sm90"),
    (torch.bfloat16, 36, 36, True, True, True, "plain"),      # the mma_sync head dims
    (torch.bfloat16, 192, 64, True, True, True, "plain"),
    (torch.bfloat16, 256, 128, True, True, True, "plain"),
    (torch.bfloat16, 64, 64, False, True, True, "plain"),     # a base off 16 bytes
    (torch.float32, 64, 64, True, True, True, "plain"),       # the fma route
    (torch.bfloat16, 64, 64, True, False, True, "plain"),     # CPU tensors
    (torch.bfloat16, 64, 64, True, True, False, "plain"),     # no log-sum-exp saved
])
def test_backward_route_by_dtype_head_dims_alignment_and_lse(dtype, d, dv, aligned, on_card,
                                                             lse, want):
    assert attention.backward_route(dtype, d, dv, aligned, on_card, lse) == want
    assert want in attention.BACKWARD_ROUTES


def test_backward_counters_reset_and_cpu_calls_launch_nothing():
    counts.add("attention_backward_dims_launches", "64/64", 3)
    counts.reset()
    assert counts["attention_backward_launches"] == 0
    assert counts["attention_backward_dims_launches"] == {}
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 3, 16, 8, generator=g).to(torch.bfloat16) for _ in range(4))
    out, lse = attention.attend_saving_lse(q, k, v, causal=True)
    assert lse is None and torch.equal(out, attention.attend(q, k, v, causal=True))
    want = attention.attention_backward(q, k, v, out, do, causal=True, scale=8 ** -0.5)
    got = attention.backward(q, k, v, out, do, None, causal=True, scale=8 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts["attention_backward_launches"] == 0 and counts["attention_launches"] == 0


def test_snapshot_exports_the_backward_counters():
    from tpu_mpi_torch import perfvars
    counts.reset()
    k = perfvars.kernels_snapshot()
    assert k["attention_backward_launches"] == 0
    assert k["attention_backward_dims_launches"] == {}
    counts.add("attention_backward_dims_launches", "192/128", 5)
    try:
        k = perfvars.kernels_snapshot()
        assert k["attention_backward_dims_launches"] == {"192/128": 5}
        assert k["attention_backward_launches"] == 5
    finally:
        counts.reset()
    assert attention.LIBRARY_BACKWARD.path().name.startswith("attention_backward_sm90-")


# The sm90 backward's arithmetic (tpu_mpi_torch/csrc/attention_backward_sm90.cu),
# replayed here: P from the forward's log-sum-exp in log2 units, 2^(s scale
# log2(e) - lse), rounded to bfloat16 for dV = P^T dO and for dS = P (dP - D);
# dS rounded to bfloat16 for dQ and dK. It stays within the card tests'
# bound of the plain backward: 2^-5 of each gradient's largest magnitude.

def _sm90_backward_replay(q, k, v, o, do, *, causal, scale):
    n, bh, t, d = q.shape
    bf, f32 = torch.bfloat16, torch.float32
    glob = lambda x: x.transpose(0, 1).reshape(bh, n * t, x.shape[-1]).float()  # noqa: E731
    qg, kg, vg, og, dog = (glob(x) for x in (q, k, v, o, do))
    c = torch.tensor(scale, dtype=f32) * torch.tensor(math.log2(math.e), dtype=f32)
    s = qg @ kg.transpose(1, 2)
    if causal:
        s = s.masked_fill(torch.ones(n * t, n * t, dtype=torch.bool).triu(1), -math.inf)
    lse = torch.logsumexp(s * scale, -1, keepdim=True) * math.log2(math.e)
    p = torch.exp2(s * c - lse).to(bf).float()
    dv = p.transpose(1, 2) @ dog
    dp = dog @ vg.transpose(1, 2)
    ds = (p * (dp - (dog * og).sum(-1, keepdim=True))).to(bf).float()
    dq, dk = ds @ kg * scale, ds.transpose(1, 2) @ qg * scale
    back = lambda x: x.view(bh, n, t, x.shape[-1]).transpose(0, 1).to(q.dtype)  # noqa: E731
    return back(dq), back(dk), back(dv)


@pytest.mark.parametrize("n,bh,t,d,dv,causal", [
    (4, 2, 32, 64, 64, True),       # the flagship's shape, cut
    (4, 2, 32, 64, 64, False),
    (2, 3, 20, 64, 64, True),       # a ragged t
    (2, 2, 24, 192, 128, True),     # latent attention's head dims
    (1, 2, 40, 40, 40, False),      # d below one panel
])
def test_sm90_backward_arithmetic_stays_inside_the_bound(n, bh, t, d, dv, causal):
    g = torch.Generator().manual_seed(n * t + d + dv)
    q, k = (torch.randn(n, bh, t, d, generator=g).to(torch.bfloat16) for _ in range(2))
    v, do = (torch.randn(n, bh, t, dv, generator=g).to(torch.bfloat16) for _ in range(2))
    scale = d ** -0.5
    o = attention.attend(q, k, v, causal=causal, scale=scale)
    want = attention.attention_backward(q, k, v, o, do, causal=causal, scale=scale)
    got = _sm90_backward_replay(q, k, v, o, do, causal=causal, scale=scale)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        err = float((a.float() - w.float()).abs().max())
        assert err <= 2.0 ** -5 * float(w.float().abs().max()), err
