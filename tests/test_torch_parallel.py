"""The port's parallelism recipes (tpu_mpi_torch.parallel) against
tpu_mpi.parallel on the conftest's 8-device CPU mesh.

The same numpy inputs, made from a seed, go through both: the JAX function
under shard_map over a one-axis mesh, the port's on the stacked per-rank
CPU tensors (rank axis first). Tolerances: data movement (the Ulysses
reshard, MoE dispatch/combine, pipeline hops of an exact stage, halo
exchange) is bitwise; ring attention is atol 1e-5, the bound of the JAX
package's own test (tests/test_parallel.py:31): the port follows the
Pallas kernel's rounding (float32-scaled scores, -inf masks), not
tpu_mpi.parallel.ring's; matmuls (tp, pipeline) atol 1e-5 for the two
libraries' float32 sums.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

import tpu_mpi
from tpu_mpi import parallel as jpar
from tpu_mpi import xla as jxla
from tpu_mpi.parallel import ulysses as julysses
from tpu_mpi_torch import parallel as tpar
from tpu_mpi_torch.parallel import ep as tep
from tpu_mpi_torch.parallel import ulysses as tulysses


def _mesh(axis: str, n: int):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return jxla.make_mesh({axis: n})


def _shard_seq(x: np.ndarray, n: int) -> torch.Tensor:
    """(b, h, T, d) -> stacked (n, b, h, T/n, d): rank r holds block r."""
    b, h, t, d = x.shape
    return torch.from_numpy(x.reshape(b, h, n, t // n, d).transpose(2, 0, 1, 3, 4)
                            .copy())


def _unshard_seq(xs: torch.Tensor) -> np.ndarray:
    n, b, h, t, d = xs.shape
    return xs.numpy().transpose(1, 2, 0, 3, 4).reshape(b, h, n * t, d)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


# ---------------------------------------------------------------------------
# Sequence parallel: ring attention, Ulysses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,causal", [(4, True), (4, False), (1, True)])
def test_ring_attention_matches(n, causal):
    q, k, v = _qkv((2, 2, 32, 8), 40 + n)
    mesh = _mesh("sp", n)
    want = jax.jit(jax.shard_map(
        lambda a, b, c: jpar.ring_attention(a, b, c, axis="sp", causal=causal),
        mesh=mesh, in_specs=(P(None, None, "sp"),) * 3,
        out_specs=P(None, None, "sp")))(q, k, v)
    got = tpar.ring_attention(*(_shard_seq(a, n) for a in (q, k, v)),
                              axis="sp", causal=causal)
    assert got.shape == (n, 2, 2, 32 // n, 8)
    np.testing.assert_allclose(_unshard_seq(got), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_ulysses_reshard_round_trip_is_bitwise():
    x = _qkv((2, 4, 32, 8), 50)[0]
    mesh = _mesh("sp", 4)
    want = jax.jit(jax.shard_map(lambda v: julysses.seq_to_heads(v, axis="sp"),
                                 mesh=mesh, in_specs=P(None, None, "sp"),
                                 out_specs=P(None, "sp")))(x)
    xs = _shard_seq(x, 4)
    heads = tpar.seq_to_heads(xs, axis="sp")
    assert heads.shape == (4, 2, 1, 32, 8)
    # rank r holds heads [r] over the whole sequence
    np.testing.assert_array_equal(heads.numpy().transpose(1, 0, 2, 3, 4)
                                  .reshape(2, 4, 32, 8), np.asarray(want))
    assert torch.equal(tpar.heads_to_seq(heads, axis="sp"), xs)


def test_ulysses_attention_matches():
    q, k, v = _qkv((2, 4, 32, 8), 51)
    mesh = _mesh("sp", 4)
    want = jax.jit(jax.shard_map(
        lambda a, b, c: julysses.ulysses_attention(a, b, c, axis="sp"),
        mesh=mesh, in_specs=(P(None, None, "sp"),) * 3,
        out_specs=P(None, None, "sp")))(q, k, v)
    got = tulysses.ulysses_attention(*(_shard_seq(a, 4) for a in (q, k, v)),
                                     axis="sp")
    np.testing.assert_allclose(_unshard_seq(got), np.asarray(want), rtol=0,
                               atol=1e-5)
    ring = tpar.ring_attention(*(_shard_seq(a, 4) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ring.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Tensor parallel
# ---------------------------------------------------------------------------

def test_column_row_parallel_matches():
    rng = np.random.default_rng(60)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w1 = rng.standard_normal((16, 32)).astype(np.float32)
    w2 = rng.standard_normal((32, 16)).astype(np.float32)
    mesh = _mesh("tp", 4)

    def body(x, w1, w2):
        h = jpar.column_parallel(x, w1, axis="tp")
        return jpar.row_parallel(h, w2, axis="tp")

    want = jax.jit(jax.shard_map(body, mesh=mesh,
                                 in_specs=(P(), P(None, "tp"), P("tp", None)),
                                 out_specs=P()))(x, w1, w2)
    # the replicated activation and the psum'd output are held once
    w1s = torch.from_numpy(w1.reshape(16, 4, 8).transpose(1, 0, 2).copy())
    w2s = torch.from_numpy(w2.reshape(4, 8, 16).copy())
    h = tpar.column_parallel(torch.from_numpy(x), w1s, axis="tp")
    assert h.shape == (4, 8, 8)
    got = tpar.row_parallel(h, w2s, axis="tp")
    assert got.shape == (8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_column_parallel_bias_and_gathered_output():
    rng = np.random.default_rng(61)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    w = rng.standard_normal((8, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    mesh = _mesh("tp", 4)

    def body(x, w, b):
        return jpar.all_gather_output(jpar.column_parallel(x, w, b, axis="tp"),
                                      axis="tp")

    want = jax.jit(jax.shard_map(body, mesh=mesh,
                                 in_specs=(P(), P(None, "tp"), P("tp")),
                                 out_specs=P(), check_vma=False))(x, w, b)
    ws = torch.from_numpy(w.reshape(8, 4, 3).transpose(1, 0, 2).copy())
    bs = torch.from_numpy(b.reshape(4, 3))
    y = tpar.column_parallel(torch.from_numpy(x), ws, bs)
    got = tpar.all_gather_output(y, axis="tp")
    assert got.shape == (4, 3, 5, 12)
    for r in range(4):
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Expert parallel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,route", [(8, "spread"), (3, "flood"), (2, "random")])
def test_moe_dispatch_combine_matches_bitwise(cap, route):
    n, t, d = 4, 8, 4
    rng = np.random.default_rng(70 + cap)
    tokens = (rng.standard_normal((n * t, d)) + 1.0).astype(np.float32)
    if route == "spread":
        idx = (np.arange(n * t) % n).astype(np.int32)
    elif route == "flood":
        idx = np.zeros(n * t, np.int32)               # everyone floods expert 0
    else:
        idx = rng.integers(0, n, n * t).astype(np.int32)
    mesh = _mesh("ep", n)

    def body(tok, ei):
        return jpar.moe_dispatch_combine(tok, ei, lambda z: 2.0 * z + 1.0,
                                         capacity=cap, axis="ep")

    want = np.asarray(jax.jit(jax.shard_map(body, mesh=mesh,
                                            in_specs=(P("ep"), P("ep")),
                                            out_specs=P("ep")))(tokens, idx))
    got = tpar.moe_dispatch_combine(
        torch.from_numpy(tokens.reshape(n, t, d)),
        torch.from_numpy(idx.reshape(n, t)), lambda z: 2.0 * z + 1.0,
        capacity=cap, axis="ep")
    np.testing.assert_array_equal(got.numpy().reshape(n * t, d), want)
    if route == "flood":
        # past capacity: exact zeros
        assert (got[:, cap:] == 0).all() and not (got[:, :cap] == 0).any()


@pytest.mark.parametrize("n", [1, 4])
def test_moe_host_dispatch_combine_matches_bitwise(n):
    import tpu_mpi_torch
    from tpu_mpi.parallel.ep import moe_host_dispatch_combine as jhost
    from tpu_mpi.testing import run_spmd as jrun
    from tpu_mpi_torch.testing import run_spmd as trun

    def make(host, mpi):
        def body():
            comm = mpi.COMM_WORLD
            size, rank = comm.size(), comm.rank()
            rng = np.random.default_rng(80 + rank)
            tokens = rng.standard_normal((6, 3)).astype(np.float32)
            idx = rng.integers(0, size, 6)
            idx[:3] = (rank + 1) % size                   # over capacity 2
            out = host(tokens, idx, lambda z: 2.0 * z - 1.0, comm, capacity=2)
            return out, idx
        return body

    want = jrun(make(jhost, tpu_mpi), n)
    got = trun(make(tep.moe_host_dispatch_combine, tpu_mpi_torch), n)
    for (w, idx), (g, _) in zip(want, got):
        np.testing.assert_array_equal(g, w)
        for e in range(n):
            dropped = np.flatnonzero(idx == e)[2:]
            assert (g[dropped] == 0).all()


# ---------------------------------------------------------------------------
# Pipeline parallel, halo exchange
# ---------------------------------------------------------------------------

def test_pipeline_forward_matches():
    n, m, b, d = 4, 3, 2, 8
    rng = np.random.default_rng(90)
    ws = (rng.standard_normal((n, d, d)) * 0.4).astype(np.float32)
    xs = rng.standard_normal((m, b, d)).astype(np.float32)
    mesh = _mesh("pp", n)

    def body(w, mb):
        return jpar.pipeline_forward(lambda wl, x: jnp.tanh(x @ wl[0]), w, mb,
                                     axis="pp")

    want = np.asarray(jax.jit(jax.shard_map(body, mesh=mesh,
                                            in_specs=(P("pp"), P()),
                                            out_specs=P("pp")))(ws, xs))
    got = tpar.pipeline_forward(lambda w, x: torch.tanh(torch.matmul(x, w)),
                                torch.from_numpy(ws), torch.from_numpy(xs),
                                axis="pp")
    assert got.shape == (n, m, b, d)
    # the last stage's emissions are the pipeline's results
    np.testing.assert_allclose(got[n - 1].numpy(), want.reshape(n, m, b, d)[n - 1],
                               rtol=0, atol=1e-5)
    dense = xs
    for r in range(n):
        dense = np.tanh(dense @ ws[r])
    np.testing.assert_allclose(got[n - 1].numpy(), dense, rtol=0, atol=1e-5)


def test_pipeline_forward_adds_stage_weights_bitwise():
    mesh = _mesh("pp", 4)
    xs = np.arange(6.0, dtype=np.float32).reshape(3, 2)
    w = np.ones((4, 1), np.float32)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda wl, mb: jpar.pipeline_forward(lambda p, x: x + p[0], wl, mb,
                                             axis="pp"),
        mesh=mesh, in_specs=(P("pp"), P()), out_specs=P("pp")))(w, xs))
    got = tpar.pipeline_forward(lambda p, x: x + p, torch.from_numpy(w),
                                torch.from_numpy(xs), axis="pp")
    np.testing.assert_array_equal(got.numpy().reshape(12, 2), want)
    np.testing.assert_array_equal(got[3].numpy(), xs + 4)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_one_axis_matches_bitwise(periodic, halo):
    rng = np.random.default_rng(95)
    x = rng.standard_normal((3, 4 * 5)).astype(np.float32)
    mesh = _mesh("cx", 4)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda v: jpar.halo_exchange(v, axes=("cx",), halo=halo,
                                     periodic=periodic),
        mesh=mesh, in_specs=P(None, "cx"), out_specs=P(None, "cx")))(x))
    xs = torch.from_numpy(x.reshape(3, 4, 5).transpose(1, 0, 2).copy())
    got = tpar.halo_exchange(xs, axes=("cx",), halo=halo, periodic=periodic)
    assert got.shape == (4, 3, 5 + 2 * halo)
    np.testing.assert_array_equal(got.numpy().transpose(1, 0, 2).reshape(3, -1),
                                  want)


def test_exports_follow_the_jax_package():
    for name in ["allreduce_grads", "pmean_tree", "all_gather_output",
                 "column_parallel", "row_parallel", "tp_identity_fwd_psum_bwd",
                 "tp_psum_fwd_identity_bwd", "ring_attention", "heads_to_seq",
                 "seq_to_heads", "moe_dispatch_combine", "pipeline_forward",
                 "halo_exchange"]:
        assert hasattr(tpar, name) and hasattr(jpar, name), name
