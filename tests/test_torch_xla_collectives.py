"""The port's in-graph tier (tpu_mpi_torch.xla) against tpu_mpi.xla under
shard_map on the conftest's 8-device CPU mesh.

The same numpy inputs, made from a seed, go through both: the JAX function
under shard_map with in_specs=P("x") (P() for the replicated inputs of
scatter and scatterv) and out_specs=P("x"), its result reshaped to the
port's stacked (n, ...) form; the port's function on the stacked CPU
tensor. Tolerance: none, except where a lowering is shown not to be the
same arithmetic — the opt-in approximate PROD (exp and log of two
libraries) and float scan/exscan (lax.associative_scan associates as a
tree, the port folds in rank order); each such test says so.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

import tpu_mpi
import tpu_mpi_torch
from tpu_mpi import xla as jxla
from tpu_mpi_torch import xla
from tpu_mpi_torch.kernels._build import counts

N = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jxla.make_mesh({"x": N})


@pytest.fixture(scope="module")
def mesh():
    return xla.make_mesh({"x": N}, devices=[CPU])


def _mixed(shape, seed, dtype=np.float32):
    """Floats at mixed magnitudes, where the order of a fold shows."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.integers(-4, 5, shape)
    return (rng.standard_normal(shape) * mag).astype(dtype)


def _jax(jmesh, fn, stacked, in_spec=P("x")):
    """``fn`` under shard_map on the stacked input (n, ...): sharded along
    the rank axis (or replicated, with in_spec P(), from row 0); the
    per-rank results come back stacked as (n, -1)."""
    g = stacked.reshape((-1,) + stacked.shape[2:]) if in_spec == P("x") \
        else stacked[0]
    f = jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=in_spec,
                              out_specs=P("x")))
    return np.asarray(f(jnp.asarray(g)))


def _same(port, want):
    port = port.numpy()
    np.testing.assert_array_equal(port, want.reshape(port.shape))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Reduce family
# ---------------------------------------------------------------------------

def _custom(a, b):
    return 2 * a - b        # non-commutative; 2a is exact


@pytest.mark.parametrize("opname", ["SUM", "MAX", "MIN", "PROD", "custom"])
def test_allreduce_matches(jmesh, opname):
    x = _mixed((N, 6, 5), 1) if opname != "PROD" else \
        np.random.default_rng(2).standard_normal((N, 6, 5)).astype(np.float32)
    jop = _custom if opname == "custom" else getattr(tpu_mpi, opname)
    top = _custom if opname == "custom" else getattr(tpu_mpi_torch, opname)
    chained = counts["chained_folds"]
    want = _jax(jmesh, lambda v: jxla.allreduce(v, jop, axis="x"), x)
    got = xla.allreduce(_t(x), top, axis="x")
    assert got.shape == (N, 6, 5)
    _same(got, want)
    # only the custom callable leaves the fold kernel's path
    assert counts["chained_folds"] == chained + (opname == "custom")


@pytest.mark.parametrize("opname", ["SUM", "PROD", "BXOR", "LAND", "LOR", "LXOR"])
def test_allreduce_integers_and_logical_ops(jmesh, opname):
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (N, 7)).astype(np.int32)
    want = _jax(jmesh, lambda v: jxla.allreduce(v, getattr(tpu_mpi, opname),
                                                axis="x"), x)
    _same(xla.allreduce(_t(x), getattr(tpu_mpi_torch, opname)), want)


def test_allreduce_approx_prod_within_tolerance(jmesh):
    # exp(sum(log|x|)): exp and log differ between XLA's CPU library and
    # PyTorch's in the last bits, so this opt-in lowering is held to 1e-5
    vals = np.random.default_rng(4).uniform(0.5, 2.0, (N, 9)).astype(np.float32)
    vals[::3] *= -1
    want = _jax(jmesh, lambda v: jxla.allreduce(v, tpu_mpi.PROD, axis="x",
                                                approx_prod=True), vals)
    got = xla.allreduce(_t(vals), tpu_mpi_torch.PROD, approx_prod=True)
    np.testing.assert_allclose(got.numpy(), want.reshape(N, 9), rtol=1e-5)
    np.testing.assert_array_equal(np.sign(got.numpy()), np.sign(want.reshape(N, 9)))


def test_reduce_is_the_allreduce(jmesh):
    x = _mixed((N, 11), 5)
    want = _jax(jmesh, lambda v: jxla.reduce(v, tpu_mpi.SUM, root=2, axis="x"), x)
    _same(xla.reduce(_t(x), tpu_mpi_torch.SUM, root=2), want)


@pytest.mark.parametrize("dim,tiled", [(0, True), (1, True), (0, False)])
def test_reduce_scatter_sum_matches(jmesh, dim, tiled):
    x = _mixed((N, N * 3 if tiled else N, 16), 6)
    want = _jax(jmesh, lambda v: jxla.reduce_scatter(
        v, tpu_mpi.SUM, axis="x", scatter_dimension=dim, tiled=tiled), x)
    got = xla.reduce_scatter(_t(x), tpu_mpi_torch.SUM, scatter_dimension=dim,
                             tiled=tiled)
    _same(got, want)


@pytest.mark.parametrize("opname", ["MAX", "PROD"])
def test_reduce_scatter_other_ops_match(jmesh, opname):
    x = np.random.default_rng(7).standard_normal((N, 2 * N + 3)).astype(np.float32)
    want = _jax(jmesh, lambda v: jxla.reduce_scatter(
        v, getattr(tpu_mpi, opname), axis="x"), x)
    _same(xla.reduce_scatter(_t(x), getattr(tpu_mpi_torch, opname)), want)


def test_bcast_matches(jmesh):
    x = _mixed((N, 4, 3), 8)
    want = _jax(jmesh, lambda v: jxla.bcast(v, root=3, axis="x"), x)
    got = xla.bcast(_t(x), root=3)
    _same(got, want)
    with pytest.raises(RuntimeError):
        got.add_(1)          # one shared result: PyTorch refuses the write


# ---------------------------------------------------------------------------
# Gather and scatter families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("fn", ["allgather", "gather"])
def test_allgather_matches(jmesh, fn, tiled):
    x = _mixed((N, 3, 2), 9)
    want = _jax(jmesh, lambda v: getattr(jxla, fn)(v, axis="x", tiled=tiled), x)
    got = getattr(xla, fn)(_t(x), tiled=tiled)
    assert got.shape == ((N, N * 3, 2) if tiled else (N, N, 3, 2))
    _same(got, want)


def test_scatter_matches(jmesh):
    full = np.broadcast_to(_mixed((N * 2 + 1, 3), 10), (N, N * 2 + 1, 3))
    want = _jax(jmesh, lambda v: jxla.scatter(v, root=0, axis="x"), full,
                in_spec=P())
    _same(xla.scatter(_t(full), root=0), want)


def test_allgatherv_and_gatherv_match(jmesh):
    counts = [1, 2, 1, 2, 1, 2, 1, 2]
    x = _mixed((N, 2, 3), 11)
    want = _jax(jmesh, lambda v: jxla.allgatherv(v, counts, axis="x"), x)
    _same(xla.allgatherv(_t(x), counts), want)
    _same(xla.gatherv(_t(x), counts, root=1), want)


def test_scatterv_matches(jmesh):
    counts = [1, 2, 3, 1, 4, 2, 1, 2]
    full = np.broadcast_to(_mixed((sum(counts) + 2,), 12), (N, sum(counts) + 2))
    want = _jax(jmesh, lambda v: jxla.scatterv(v, counts, axis="x"), full,
                in_spec=P())
    _same(xla.scatterv(_t(full), counts), want)


# ---------------------------------------------------------------------------
# Movement and prefix functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split,concat,tiled", [(0, 0, True), (1, 0, True),
                                                (0, 1, False), (1, 0, False)])
def test_alltoall_matches(jmesh, split, concat, tiled):
    x = _mixed((N, N * 2 if tiled else N, N), 13)
    want = _jax(jmesh, lambda v: jxla.alltoall(
        v, axis="x", split_axis=split, concat_axis=concat, tiled=tiled), x)
    _same(xla.alltoall(_t(x), split_axis=split, concat_axis=concat,
                       tiled=tiled), want)


def test_alltoallv_matches(jmesh):
    counts = np.random.default_rng(14).integers(0, 4, (N, N)).tolist()
    width = max(sum(row) for row in counts)
    x = _mixed((N, width), 15)
    want = _jax(jmesh, lambda v: jxla.alltoallv(v, counts, axis="x"), x)
    _same(xla.alltoallv(_t(x), counts), want)


@pytest.mark.parametrize("fn", ["scan", "exscan"])
def test_scan_integers_bitwise(jmesh, fn):
    x = np.random.default_rng(16).integers(-50, 50, (N, 6)).astype(np.int64)
    want = _jax(jmesh, lambda v: getattr(jxla, fn)(v, tpu_mpi.SUM, axis="x"), x)
    _same(getattr(xla, fn)(_t(x), tpu_mpi_torch.SUM), want)


@pytest.mark.parametrize("fn", ["scan", "exscan"])
def test_scan_floats_within_tolerance(jmesh, fn):
    # lax.associative_scan adds as a tree, the port in rank order (MPI's
    # Scan order): float32 prefixes agree to rounding, rtol 1e-5 on values
    # of one magnitude
    x = np.random.default_rng(17).uniform(1.0, 2.0, (N, 6)).astype(np.float32)
    want = _jax(jmesh, lambda v: getattr(jxla, fn)(v, tpu_mpi.SUM, axis="x"), x)
    got = getattr(xla, fn)(_t(x), tpu_mpi_torch.SUM).numpy()
    want = want.reshape(N, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # up to three operands the tree and the rank order are the same sums
    rows = 3 if fn == "scan" else 4
    np.testing.assert_array_equal(got[:rows], want[:rows])


@pytest.mark.parametrize("shift", [1, -2, 3])
def test_ring_shift_matches(jmesh, shift):
    x = _mixed((N, 5), 18)
    want = _jax(jmesh, lambda v: jxla.ring_shift(v, axis="x", shift=shift), x)
    _same(xla.ring_shift(_t(x), shift=shift), want)


def test_sendrecv_matches(jmesh):
    dest = [7, None, 5, -1, 0, 2, 4, 1]
    x = _mixed((N, 5), 19)
    want = _jax(jmesh, lambda v: jxla.sendrecv(v, dest=dest, axis="x"), x)
    _same(xla.sendrecv(_t(x), dest=dest), want)
    with pytest.raises(ValueError):
        xla.sendrecv(_t(x), dest=[1, 1, 2, 3, 4, 5, 6, 7])


# ---------------------------------------------------------------------------
# rank, size, barrier and the mesh
# ---------------------------------------------------------------------------

def test_rank_size_barrier_match(jmesh, mesh):
    want_rank = _jax(jmesh, lambda v: jxla.rank("x")[None], np.zeros((N, 1)))
    want_bar = _jax(jmesh, lambda v: jxla.barrier("x")[None], np.zeros((N, 1)))
    _same(xla.rank(mesh, "x"), want_rank)
    _same(xla.barrier(mesh, "x"), want_bar)
    assert xla.size(mesh, "x") == N
    with pytest.raises(ValueError):
        xla.size(mesh, "y")


def test_mesh_rank_order_and_wrapping():
    devs = [torch.device("cpu", 0), torch.device("meta")]
    m = xla.make_mesh({"x": 5}, devices=devs)
    assert m.shape == {"x": 5} and m.axis_names == ("x",)
    assert [d.type for d in m.devices] == ["cpu", "meta", "cpu", "meta", "cpu"]
    with pytest.raises(NotImplementedError):
        m.device             # ranks on two devices: no one stacked device
    one = xla.make_mesh([3], names=["r"], devices=[CPU])
    assert one.devices == (CPU,) * 3 and one.device == CPU


def test_default_mesh_wraps_ranks_onto_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = xla.make_mesh({"x": 5})
    assert [str(d) for d in m.devices] == ["cuda:0", "cuda:1", "cuda:0",
                                           "cuda:1", "cuda:0"]
    assert xla.world_mesh("w").shape == {"w": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert xla.make_mesh({"x": 4}).device == torch.device("cuda", 0)


def test_cpu_mesh_only_on_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert xla.local_device_count() == 0
    with pytest.raises(RuntimeError, match="cpu"):
        xla.make_mesh({"x": 4})
    with pytest.raises(RuntimeError):
        xla.world_mesh()
    assert xla.make_mesh({"x": 4}, devices=[CPU]).device == CPU


def test_comm_mesh_follows_the_comm_rank_order():
    class Ctx:
        def device_for(self, w):
            return torch.device("cpu", w)

    class FakeComm:
        group = (2, 0, 3)
        ctx = Ctx()

    m = xla.comm_mesh(FakeComm(), "c")
    assert m.shape == {"c": 3}
    assert [d.index for d in m.devices] == [2, 0, 3]
    w = xla.comm_mesh(FakeComm(), devices=[torch.device("cpu", 0),
                                           torch.device("cpu", 1)])
    assert [d.index for d in w.devices] == [0, 0, 1]


def test_comm_mesh_of_world_inside_spmd_run():
    def body():
        comm = tpu_mpi_torch.COMM_WORLD
        m = xla.comm_mesh(comm, devices=[CPU])
        return m.size, m.device.type

    assert tpu_mpi_torch.spmd_run(body, 3, timeout=60) == [(3, "cpu")] * 3


def test_exports_carry_the_jax_names():
    for name in ["allgather", "allgatherv", "allreduce", "alltoall",
                 "alltoallv", "barrier", "bcast", "exscan", "gather",
                 "gatherv", "rank", "reduce", "reduce_scatter", "ring_shift",
                 "scan", "scatter", "scatterv", "sendrecv", "size",
                 "comm_mesh", "local_device_count", "make_mesh", "world_mesh"]:
        assert callable(getattr(jxla, name)) and callable(getattr(xla, name))
    for name in ["ring_allreduce", "ring_reduce_scatter", "ring_allgather",
                 "fused_multi_reduce"]:
        assert callable(getattr(jxla.pallas_kernels, name))
        assert callable(getattr(xla, name))
