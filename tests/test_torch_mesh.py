"""Meshes of several axes in the port (tpu_mpi_torch.xla.mesh, the
collectives over a sub-axis or a tuple of axes, the recipes over a
sub-axis, the differentiable permute and all-to-all, N-d Cartesian meshes)
against tpu_mpi on the conftest's 8-device CPU mesh.

The stacked layout is one leading rank dim per mesh axis, in the mesh's
order: the JAX side runs under shard_map with every rank dim sharded over
its axis, so its result comes back in the same layout. Movement and folds
are bitwise, over a tuple of axes too: ``lax.psum`` over a tuple folds the
ranks of the group in the tuple's order, row-major, on the CPU mesh
(measured here for ("dp", "sp") and ("sp", "dp") on data where the order
shows), and the port folds them so. Gradients of the permute and the
all-to-all are checked against ``jax.vjp`` of ``ppermute`` and
``all_to_all`` bitwise (movement); the recipes' gradients (ring attention,
the f/g pair, MoE dispatch, the pipeline) against ``jax.grad`` at atol
1e-5 float32, as ``tests/test_torch_train_step.py`` states.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import tpu_mpi_torch as MPI
from tpu_mpi import parallel as jpar
from tpu_mpi import xla as jxla
from tpu_mpi_torch import parallel as tpar
from tpu_mpi_torch import xla
from tpu_mpi_torch.kernels import fused_reduce as fr
from tpu_mpi_torch.kernels import permute
from tpu_mpi_torch.xla import collectives as xc

AXES = {"dp": 2, "tp": 2, "sp": 2}
CPU = torch.device("cpu")
ATOL = 1e-5


def _mixed(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 5, shape)).astype(dtype)


def _jax(axes, fn, stacked):
    """``fn`` per rank under shard_map, every leading rank dim sharded over
    its axis; the results stacked the same way."""
    mesh = jxla.make_mesh(axes)
    k = len(axes)
    spec = P(*axes)

    def body(x):
        y = fn(x.reshape(x.shape[k:]))
        return y.reshape((1,) * k + y.shape)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec,
                              check_vma=False))
    return np.asarray(f(jnp.asarray(stacked)))


def _same(got, want):
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_of_two_to_four_axes():
    for axes in ({"a": 2, "b": 3}, AXES, {"dp": 2, "tp": 1, "sp": 2, "pp": 2}):
        m = xla.make_mesh(axes, devices=[CPU])
        assert m.shape == axes and m.axis_names == tuple(axes)
        assert m.size == int(np.prod(list(axes.values()))) and m.device == CPU
    m = xla.make_mesh([2, 2], names=["x", "y"], devices=[CPU])
    assert m.rank_dims(("y", "x")) == (1, 0) and m.axis_size("y") == 2
    with pytest.raises(ValueError):
        m.rank_dims("z")
    with pytest.raises(ValueError, match="repeat"):
        xla.make_mesh([2, 2], names=["x", "x"], devices=[CPU])
    with pytest.raises(ValueError, match="3 devices"):
        xla.Mesh({"x": 2, "y": 2}, [CPU] * 3)


def test_rank_size_barrier_over_sub_axes_and_tuples():
    mesh = xla.make_mesh(AXES, devices=[CPU])
    zeros = np.zeros((2, 2, 2, 1))
    for axis in ("dp", "sp", ("sp", "dp"), ("dp", "tp", "sp")):
        want = _jax(AXES, lambda v: lax.axis_index(axis)[None], zeros)
        _same(xla.rank(mesh, axis)[..., None], want.astype(np.int32))
        assert xla.size(mesh, axis) == (2 if isinstance(axis, str) else 2 ** len(axis))
    assert xla.barrier(mesh, "tp").shape == (2, 2, 2)


# ---------------------------------------------------------------------------
# folds over a sub-axis and over tuples: the order the JAX psum folds in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["dp", "tp", "sp", ("dp", "sp"), ("sp", "dp"),
                                  ("tp", "dp"), ("sp", "tp", "dp")])
def test_psum_over_sub_axes_and_tuples_is_bitwise(axis):
    x = _mixed((2, 2, 2, 4000), 1)
    want = _jax(AXES, lambda v: lax.psum(v, axis), x)
    got = xla.allreduce(torch.from_numpy(x), axis=axis, mesh=AXES)
    _same(got, want)


def test_the_tuple_order_shows_on_this_data():
    # ("dp", "sp") and ("sp", "dp") give different bits here, so the
    # bitwise test above pins the order
    x = torch.from_numpy(_mixed((2, 2, 2, 4000), 1))
    a = xla.allreduce(x, axis=("dp", "sp"), mesh=AXES)
    b = xla.allreduce(x, axis=("sp", "dp"), mesh=AXES)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("op,jop", [("MAX", lax.pmax), ("MIN", lax.pmin)])
def test_pmax_pmin_over_a_tuple(op, jop):
    x = _mixed((2, 2, 2, 64), 2)
    want = _jax(AXES, lambda v: jop(v, ("sp", "tp")), x)
    _same(xla.allreduce(torch.from_numpy(x), getattr(MPI, op), axis=("sp", "tp"),
                        mesh=AXES), want)


def test_custom_op_over_a_tuple_folds_axis_by_axis():
    # tpu_mpi.xla.allreduce folds a custom op over each axis of the tuple in
    # turn (an all_gather and a fold per axis)
    x = _mixed((2, 2, 2, 16), 3)

    def op(a, b):
        return 2 * a - b

    want = _jax(AXES, lambda v: jxla.allreduce(v, op, axis=("sp", "dp")), x)
    _same(xla.allreduce(torch.from_numpy(x), op, axis=("sp", "dp"), mesh=AXES), want)


@pytest.mark.parametrize("axis", ["sp", ("dp", "sp")])
def test_reduce_scatter_over_sub_axes(axis):
    x = _mixed((2, 2, 2, 8, 3), 4)
    want = _jax(AXES, lambda v: lax.psum_scatter(v, axis, scatter_dimension=0,
                                                 tiled=True), x)
    _same(xla.reduce_scatter(torch.from_numpy(x), axis=axis, mesh=AXES), want)


def test_one_fold_launch_for_every_group(monkeypatch):
    calls = []
    plain = fr.fused_multi_reduce_plain
    monkeypatch.setattr(fr, "fused_multi_reduce_plain",
                        lambda xs, op: calls.append(len(xs)) or plain(xs, op))
    xc.reset_layout_copies()
    x = torch.randn(2, 2, 2, 5)
    xla.allreduce(x, axis="dp", mesh=AXES)          # leads: no copy
    xla.allreduce(x, axis="sp", mesh=AXES)
    xla.allreduce(x, axis=("sp", "dp"), mesh=AXES)
    assert calls == [2, 2, 4]
    assert xc.layout_copies == 2 and xc.layout_copy_bytes == 2 * x.numel() * 4


# ---------------------------------------------------------------------------
# movement over a sub-axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,tiled", [("tp", False), ("sp", True),
                                        (("dp", "sp"), False)])
def test_allgather_over_sub_axes(axis, tiled):
    x = _mixed((2, 2, 2, 3, 2), 5)
    want = _jax(AXES, lambda v: lax.all_gather(v, axis, tiled=tiled), x)
    _same(xla.allgather(torch.from_numpy(x), axis=axis, mesh=AXES, tiled=tiled), want)


def test_bcast_and_scan_over_a_sub_axis():
    x = np.random.default_rng(6).integers(-50, 50, (2, 2, 2, 7)).astype(np.int32)
    want = _jax(AXES, lambda v: jxla.bcast(v, root=1, axis="tp"), x)
    _same(xla.bcast(torch.from_numpy(x), root=1, axis="tp", mesh=AXES), want)
    want = _jax(AXES, lambda v: jxla.scan(v, axis="sp"), x)
    _same(xla.scan(torch.from_numpy(x), axis="sp", mesh=AXES), want)


@pytest.mark.parametrize("split,concat,tiled", [(0, 0, True), (0, 1, True),
                                                (1, 0, True), (0, 1, False)])
@pytest.mark.parametrize("axis", ["dp", "sp"])
def test_alltoall_over_a_sub_axis(axis, split, concat, tiled):
    shape = (2, 2, 2, 4, 2) if tiled else (2, 2, 2, 2, 3)
    x = _mixed(shape, 7)
    want = _jax(AXES, lambda v: lax.all_to_all(v, axis, split, concat, tiled=tiled), x)
    t = torch.from_numpy(x)
    _same(xla.alltoall(t, axis=axis, mesh=AXES, split_axis=split,
                       concat_axis=concat, tiled=tiled), want)
    # the kernel route on the rows, as a CUDA tensor takes it
    group = xc._Group(t, axis, AXES, "alltoall")
    _same(group.back(xc._alltoall_rows(group.rows(t), split, concat, tiled)), want)


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_ring_shift_and_sendrecv_over_a_sub_axis(axis):
    x = _mixed((2, 2, 2, 5), 8)
    want = _jax(AXES, lambda v: jxla.ring_shift(v, axis=axis, shift=1), x)
    t = torch.from_numpy(x)
    _same(xla.ring_shift(t, axis=axis, mesh=AXES), want)
    want = _jax(AXES, lambda v: jxla.sendrecv(v, dest=[None, 0], axis=axis), x)
    _same(xla.sendrecv(t, dest=[None, 0], axis=axis, mesh=AXES), want)
    group = xc._Group(t, axis, AXES, "sendrecv")
    got = xc._PermuteRows.apply(group.flat(t), (1, -1))
    _same(group.back(got.view(group.rows(t).shape)), want)


# ---------------------------------------------------------------------------
# gradients of the permute and the all-to-all
# ---------------------------------------------------------------------------

def _vjp(axes, fn, x, cot):
    """jax.vjp of ``fn`` per rank, stacked as ``_jax`` stacks."""
    mesh = jxla.make_mesh(axes)
    k = len(axes)
    spec = P(*axes)

    def body(a, c):
        y, back = jax.vjp(fn, a.reshape(a.shape[k:]))
        return back(c.reshape(y.shape))[0].reshape(a.shape)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
                              check_vma=False))
    return np.asarray(f(jnp.asarray(x), jnp.asarray(cot)))


@pytest.mark.parametrize("dest", [[1, 0], [None, 0]])
def test_permute_backward_is_the_inverse_permute(dest):
    x = _mixed((2, 2, 2, 6), 9)
    cot = _mixed((2, 2, 2, 6), 10)
    want = _vjp(AXES, lambda v: jxla.sendrecv(v, dest=dest, axis="tp"), x, cot)
    t = torch.from_numpy(x)
    group = xc._Group(t, "tp", AXES, "sendrecv")
    src = tuple(xc._pair_sources([(i, d) for i, d in enumerate(dest) if d is not None], 2))
    for route in ("kernel", "plain"):
        leaf = t.clone().requires_grad_()
        if route == "kernel":
            flat = group.flat(leaf)
            out = group.back(xc._PermuteRows.apply(flat, src).view(group.rows(leaf).shape))
        else:
            out = xla.sendrecv(leaf, dest=dest, axis="tp", mesh=AXES)
        out.backward(torch.from_numpy(cot))
        _same(leaf.grad, want)


@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0)])
def test_alltoall_backward_is_the_swapped_alltoall(split, concat):
    x = _mixed((2, 2, 2, 4, 6), 11)
    fn = lambda v: lax.all_to_all(v, "sp", split, concat, tiled=True)  # noqa: E731
    y = _jax(AXES, fn, x)
    cot = _mixed(y.shape, 12)
    want = _vjp(AXES, fn, x, cot)
    t = torch.from_numpy(x)
    group = xc._Group(t, "sp", AXES, "alltoall")
    for route in ("kernel", "plain"):
        leaf = t.clone().requires_grad_()
        if route == "kernel":
            out = group.back(xc._alltoall_rows(group.rows(leaf), split, concat, True))
        else:
            out = xla.alltoall(leaf, axis="sp", mesh=AXES, split_axis=split,
                               concat_axis=concat)
        out.backward(torch.from_numpy(cot))
        _same(leaf.grad, want)


def test_psum_backward_is_the_psum():
    x = torch.randn(2, 2, 2, 3, dtype=torch.float64, requires_grad=True)
    cot = torch.randn(2, 2, 2, 3, dtype=torch.float64)
    xla.allreduce(x, axis=("dp", "sp"), mesh=AXES).backward(cot)
    assert torch.equal(x.grad, xla.allreduce(cot, axis=("dp", "sp"), mesh=AXES))


def test_kernel_routes_launch_one_permute_per_call(monkeypatch):
    moved = []
    plain = permute.permute_rows_plain
    monkeypatch.setattr(permute, "permute_rows_plain",
                        lambda xs, src: moved.append(tuple(xs.shape)) or plain(xs, src))
    t = torch.randn(2, 2, 2, 5, requires_grad=True)
    group = xc._Group(t, "sp", AXES, "ring_shift")
    out = xc._PermuteRows.apply(group.flat(t), (1, 0))
    out.sum().backward()
    assert moved == [(2, 20), (2, 20)]     # forward and backward, all 4 groups


# ---------------------------------------------------------------------------
# recipes over a sub-axis
# ---------------------------------------------------------------------------

def test_ring_attention_over_the_sp_sub_axis():
    axes = {"dp": 2, "sp": 4}
    rng = np.random.default_rng(20)
    q, k, v, c = (rng.standard_normal((2, 4, 2, 2, 8, 8)).astype(np.float32)
                  for _ in range(4))
    ring = lambda a, b_, c_: jpar.ring_attention(a, b_, c_, axis="sp")  # noqa: E731
    mesh = jxla.make_mesh(axes)
    spec = P("dp", "sp")

    def body(a, b_, c_, cc):
        sq = lambda x: x.reshape(x.shape[2:])  # noqa: E731
        out, back = jax.vjp(ring, sq(a), sq(b_), sq(c_))
        grads = back(sq(cc))
        return tuple(g.reshape(a.shape) for g in (out,) + grads)

    want = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                                 out_specs=(spec,) * 4, check_vma=False))(q, k, v, c)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tpar.ring_attention(*ts, axis="sp", mesh=axes)
    out.backward(torch.from_numpy(c))
    for got, w in zip([out] + [t.grad for t in ts], want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_ulysses_over_the_sp_sub_axis():
    axes = {"dp": 2, "sp": 2}
    rng = np.random.default_rng(30)
    q, k, v = (rng.standard_normal((2, 2, 1, 4, 8, 8)).astype(np.float32)
               for _ in range(3))
    mesh = jxla.make_mesh(axes)
    spec = P("dp", "sp")
    want = jax.jit(jax.shard_map(
        lambda a, b_, c_: jpar.ulysses.ulysses_attention(
            a[0, 0], b_[0, 0], c_[0, 0], axis="sp")[None, None],
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False))(q, k, v)
    got = tpar.ulysses_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 axis="sp", mesh=axes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_f_g_pair_with_other_rank_dims_matches_jax():
    # column/row-parallel over tp with a dp rank dim riding along
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)          # (dp, m, d)
    w1 = rng.standard_normal((8, 16)).astype(np.float32)
    w2 = rng.standard_normal((16, 8)).astype(np.float32)
    c = rng.standard_normal((2, 3, 8)).astype(np.float32)
    mesh = jxla.make_mesh({"dp": 2, "tp": 4})

    def local(x, w1, w2, c):
        def loss(x, w1, w2):
            h = jpar.column_parallel(x, w1, axis="tp")
            return (jpar.row_parallel(jnp.tanh(h), w2, axis="tp") * c).sum()
        gx, g1, g2 = jax.grad(loss, argnums=(0, 1, 2))(x, w1, w2)
        return gx, g1[None], g2[None]

    gx, gw1, gw2 = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("dp"), P(None, "tp"), P("tp", None), P("dp")),
        out_specs=(P("dp"), P("dp", None, "tp"), P("dp", "tp", None)),
        check_vma=False))(x.reshape(6, 8), w1, w2, c.reshape(6, 8))
    xt = torch.from_numpy(x).requires_grad_()
    w1s = torch.from_numpy(w1.reshape(8, 4, 4).transpose(1, 0, 2).copy())
    w2s = torch.from_numpy(w2.reshape(4, 4, 8).copy())
    # per-rank weight copies (n_tp, n_dp, ...) take per-rank gradients
    w1r = w1s[:, None].expand(4, 2, 8, 4).detach().requires_grad_()
    w2r = w2s[:, None].expand(4, 2, 4, 8).detach().requires_grad_()
    y = tpar.row_parallel(torch.tanh(tpar.column_parallel(xt, w1r)), w2r)
    assert y.shape == (2, 3, 8)
    (y * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx).reshape(2, 3, 8),
                               rtol=0, atol=ATOL)
    want1 = np.asarray(gw1).reshape(2, 8, 4, 4).transpose(2, 0, 1, 3)
    np.testing.assert_allclose(w1r.grad.numpy(), want1, rtol=0, atol=ATOL)
    want2 = np.asarray(gw2).reshape(2, 4, 4, 8).transpose(1, 0, 2, 3)
    np.testing.assert_allclose(w2r.grad.numpy(), want2, rtol=0, atol=ATOL)


def test_moe_dispatch_combine_trains_over_the_ep_sub_axis():
    axes = {"dp": 2, "ep": 4}
    rng = np.random.default_rng(50)
    tok = rng.standard_normal((2, 4, 12, 8)).astype(np.float32)
    idx = rng.choice(4, (2, 4, 12), p=[0.4, 0.3, 0.2, 0.1]).astype(np.int32)
    w = rng.standard_normal((4, 8, 8)).astype(np.float32) / 3
    mesh = jxla.make_mesh(axes)

    def local(t, i, w_):
        def loss(t, w_):
            out = jpar.moe_dispatch_combine(t, i, lambda z: jnp.tanh(z @ w_),
                                            capacity=3, axis="ep")
            return (out ** 2).sum()
        return jax.grad(loss, argnums=(0, 1))(t[0, 0], w_[0])

    gt, gw = jax.jit(jax.shard_map(
        lambda t, i, w_: tuple(g[None, None] for g in local(t, i[0, 0], w_)),
        mesh=mesh, in_specs=(P("dp", "ep"), P("dp", "ep"), P("ep")),
        out_specs=(P("dp", "ep"), P("dp", "ep")), check_vma=False))(tok, idx, w)
    tt = torch.from_numpy(tok).requires_grad_()
    wr = torch.from_numpy(w)[None].expand(2, 4, 8, 8).detach().requires_grad_()
    out = tpar.moe_dispatch_combine(tt, torch.from_numpy(idx),
                                    lambda z: torch.tanh(torch.matmul(z, wr)),
                                    capacity=3, axis="ep", mesh=axes)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=0, atol=ATOL)
    np.testing.assert_allclose(wr.grad.numpy(), np.asarray(gw), rtol=0, atol=ATOL)


def test_pipeline_forward_trains_over_the_pp_sub_axis():
    axes = {"dp": 2, "pp": 4}
    rng = np.random.default_rng(60)
    mbs = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)        # (dp, m, b, d)
    w = rng.standard_normal((4, 8, 8)).astype(np.float32) / 3         # a stage a rank
    mesh = jxla.make_mesh(axes)

    def local(mb, w_):
        def loss(mb, w_):
            out = jpar.pipeline_forward(lambda p, x: jnp.tanh(x @ p), w_, mb, axis="pp")
            last = lax.axis_index("pp") == 3
            return jnp.where(last, (out ** 2).sum(), 0.0)
        return jax.grad(loss, argnums=(0, 1))(mb, w_)

    gm, gw = jax.jit(jax.shard_map(
        lambda mb, w_: tuple(g[None, None] for g in local(mb[0], w_[0])),
        mesh=mesh, in_specs=(P("dp"), P("pp")), out_specs=(P("dp", "pp"), P("dp", "pp")),
        check_vma=False))(mbs, w)
    mt = torch.from_numpy(mbs)[:, None].expand(2, 4, 3, 2, 8).detach().requires_grad_()
    wr = torch.from_numpy(w)[None].expand(2, 4, 8, 8).detach().requires_grad_()
    out = tpar.pipeline_forward(lambda p, x: torch.tanh(torch.matmul(x, p)), wr, mt,
                                axis="pp", mesh=axes)
    assert out.shape == (2, 4, 3, 2, 8)
    (out[:, 3] ** 2).sum().backward()
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(gm), rtol=0, atol=ATOL)
    np.testing.assert_allclose(wr.grad.numpy(), np.asarray(gw), rtol=0, atol=ATOL)


@pytest.mark.parametrize("periodic", [True, False])
def test_halo_exchange_of_two_axes(periodic):
    axes = {"cy": 2, "cx": 4}
    x = _mixed((2, 4, 3, 5, 6), 70)
    want = _jax(axes, lambda v: jpar.halo_exchange(v, axes=("cy", "cx"), halo=2,
                                                   periodic=periodic), x)
    got = tpar.halo_exchange(torch.from_numpy(x), axes=("cy", "cx"), halo=2,
                             periodic=periodic, mesh=axes)
    _same(got, want)
    with pytest.raises(ValueError, match="mesh="):
        tpar.halo_exchange(torch.from_numpy(x), axes=("cy", "cx"))


# ---------------------------------------------------------------------------
# Cartesian grids as meshes
# ---------------------------------------------------------------------------

def test_nd_cart_grid_maps_onto_the_mesh_row_major():
    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        grid = MPI.Cart_create(comm, [2, 2, 2], [0, 1, 0], False)
        devs = [torch.device("cpu", w) for w in range(8)]
        mesh = grid.device_mesh(("dp", "tp", "sp"), devices=devs)
        coords = [grid.coords_of_rank(r) for r in range(8)]
        via = xla.comm_mesh(grid, devices=devs)
        MPI.Finalize()
        return mesh.shape, [d.index for d in mesh.devices], coords, via.axis_names

    shape, order, coords, names = MPI.spmd_run(body, 8, timeout=60)[0]
    assert shape == AXES and names == ("cart0", "cart1", "cart2")
    # mesh position np.unravel_index(r, shape) holds cart rank r
    assert order == list(range(8))
    assert coords == [list(np.unravel_index(r, (2, 2, 2))) for r in range(8)]


def test_allreduce_grads_and_pmean_tree_over_a_tuple():
    x = _mixed((2, 2, 2, 6), 80)
    want = _jax(AXES, lambda v: jpar.allreduce_grads({"w": v}, ("dp", "sp"))["w"], x)
    got = tpar.allreduce_grads({"w": torch.from_numpy(x)}, ("dp", "sp"), mesh=AXES)
    _same(got["w"], want)
    want = _jax(AXES, lambda v: jpar.pmean_tree([v], "tp")[0], x)
    got = tpar.pmean_tree([torch.from_numpy(x)], "tp", mesh=AXES)
    _same(got[0], want)
