"""The port's collective permute and pairwise all-to-all
(tpu_mpi_torch.kernels.permute) against the Pallas kernels they replace
(tpu_mpi.xla.pallas_kernels.collective_permute, pairwise_alltoall), which
run here in interpret mode on the conftest's 8-device CPU mesh, as
tests/test_pallas_kernels.py runs them; and the in-graph tier's kernel
routes (xla.alltoall, ring_shift, sendrecv on a CUDA tensor) replayed on
the CPU against the tier's own plain code.

The same numpy inputs, made from a seed, go through both: the JAX kernel
under shard_map with in_specs=P("x"), the port's wrapper on the stacked
(n, ...) CPU tensor, where it runs its plain version. Tolerance: none —
pure data movement, every case bitwise (bfloat16 compared as raw bits).
All the JAX kernels for one mesh size run as one compiled program.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from tpu_mpi import xla as jxla
from tpu_mpi.xla import pallas_kernels as pk
from tpu_mpi_torch import xla
from tpu_mpi_torch.buffers import from_numpy, to_numpy
from tpu_mpi_torch.kernels import permute
from tpu_mpi_torch.kernels import ring
from tpu_mpi_torch.xla import collectives as xc
from tpu_mpi_torch.kernels._build import counts

# (n, kernel, dtype, per-rank size)
CASES = [
    (4, "permute", "float32", 37),
    (4, "permute", "bfloat16", 300),
    (4, "permute", "int32", 5),
    (4, "alltoall", "float32", 4 * 30),
    (4, "alltoall", "bfloat16", 4 * 129),
    (4, "alltoall", "int32", 4 * 7),
    (8, "permute", "float32", 130),
    (8, "permute", "int32", 16),
    (8, "alltoall", "float32", 8 * 3),
    (8, "alltoall", "bfloat16", 8 * 17),
]


def _case_id(case):
    return "n{}-{}-{}-{}".format(*case)


def _perm(n: int) -> list:
    return np.random.default_rng(n).permutation(n).tolist()


def _inputs(case) -> np.ndarray:
    n, _, dtype, size = case
    rng = np.random.default_rng(CASES.index(case) + 300)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (n, size)).astype(np.int32)
    return rng.standard_normal((n, size)).astype(np.float32)


def _bits(a: np.ndarray, dtype: str) -> np.ndarray:
    return a.view(np.uint16) if dtype == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _jax_results(n: int) -> dict:
    cases = [c for c in CASES if c[0] == n]
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    mesh = jxla.make_mesh({"x": n})
    perm = _perm(n)

    def body(*vs):
        return tuple(pk.collective_permute(v, perm, axis="x") if c[1] == "permute"
                     else pk.pairwise_alltoall(v, axis="x")
                     for c, v in zip(cases, vs))

    specs = tuple(P("x") for _ in cases)
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs, out_specs=specs,
                              check_vma=False))
    args = [jnp.asarray(_inputs(c).reshape(-1),
                        dtype=jnp.bfloat16 if c[2] == "bfloat16" else c[2])
            for c in cases]
    return {c: _bits(np.asarray(out), c[2]).reshape(n, -1)
            for c, out in zip(cases, f(*args))}


def _port(case) -> np.ndarray:
    n, kernel, dtype, _ = case
    xs = from_numpy(_inputs(case), "cpu")
    if dtype == "bfloat16":
        xs = xs.to(torch.bfloat16)
    if kernel == "permute":
        out = permute.collective_permute(xs, _perm(n))
    else:
        out = permute.pairwise_alltoall(xs)
    assert out.device.type == "cpu" and out.dtype == xs.dtype
    return to_numpy(out)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_movement_matches_pallas_kernel(case):
    want = _jax_results(case[0])[case]
    got = _port(case)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("perm", [[0, 0, 1, 2], [1, 2, 3], [0, 1, 2, 4]])
def test_non_permutation_raises_as_the_pallas_wrapper_does(perm):
    xs = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="not a permutation"):
        permute.collective_permute(xs, perm)
    if len(perm) == 4 and len(jax.devices()) >= 4:
        mesh = jxla.make_mesh({"x": 4})
        f = jax.shard_map(lambda v: pk.collective_permute(v, perm, axis="x"),
                          mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                          check_vma=False)
        with pytest.raises(ValueError):
            f(jnp.zeros(32, jnp.float32))


def test_alltoall_block_semantics():
    # rank s's block for rank d lands in rank d's slot s
    n, per = 4, 3
    x = np.zeros((n, n * per), np.float32)
    for s in range(n):
        for d in range(n):
            x[s, d * per:(d + 1) * per] = 100 * s + 10 * d + np.arange(per)
    got = permute.pairwise_alltoall(torch.from_numpy(x)).numpy()
    for d in range(n):
        for s in range(n):
            np.testing.assert_array_equal(got[d, s * per:(s + 1) * per],
                                          100 * s + 10 * d + np.arange(per))


def test_partial_table_gives_zeros():
    xs = torch.arange(1.0, 13.0).reshape(4, 3)
    out = permute.permute_rows(xs, [-1, 0, -1, 2])
    assert torch.equal(out[1], xs[0]) and torch.equal(out[3], xs[2])
    assert (out[0] == 0).all() and (out[2] == 0).all()
    with pytest.raises(ValueError):
        permute.permute_rows(xs, [0, 1, 2])           # one source per destination
    with pytest.raises(ValueError):
        permute.permute_rows(xs, [0, 1, 2, -2])


def test_one_rank_returns_what_the_tpu_wrappers_return():
    xs = torch.arange(6.0).reshape(1, 2, 3)
    assert torch.equal(permute.pairwise_alltoall(xs), xs.reshape(1, 6))
    assert torch.equal(permute.collective_permute(xs, [0]), xs)
    with pytest.raises(ValueError):
        permute.pairwise_alltoall(torch.zeros(3, 4))   # 4 does not split over 3


# The kernel routes of the in-graph tier, replayed on the CPU: the block
# arrangement around the alltoall kernel and the source tables of the
# permute kernel give what the tier's plain code gives (which
# tests/test_torch_xla_collectives.py holds against tpu_mpi.xla).

@pytest.mark.parametrize("shape,split,concat,tiled", [
    ((4, 8, 3), 0, 0, True),
    ((4, 3, 8), 1, 0, True),
    ((4, 8, 3), 0, 1, True),
    ((4, 2, 8, 6, 5), 1, 2, True),        # Ulysses seq -> heads
    ((4, 2, 2, 24, 5), 2, 1, True),       # Ulysses heads -> seq
    ((4, 4, 3), 0, 1, False),
    ((4, 3, 4, 2), 1, 0, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_alltoall_kernel_route_matches_plain_code(shape, split, concat, tiled, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).mul(100).to(dtype)
    want = xla.alltoall(x, split_axis=split, concat_axis=concat, tiled=tiled)
    got = xc._alltoall_blocks(x, split, concat, tiled)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("shift", [1, -1, 3, 9])
def test_ring_shift_kernel_route_matches_plain_code(shift):
    x = torch.randn(5, 4, 3)
    got = permute.permute_rows(x, xc._shift_sources(5, shift))
    assert torch.equal(got, xla.ring_shift(x, shift=shift))


def test_sendrecv_kernel_route_matches_plain_code():
    dest = [7, None, 5, -1, 0, 2, 4, 1]
    x = torch.randn(8, 5)
    pairs = [(i, int(d)) for i, d in enumerate(dest) if d is not None and d >= 0]
    got = permute.permute_rows(x, xc._pair_sources(pairs, 8))
    assert torch.equal(got, xla.sendrecv(x, dest=dest))


def test_cpu_tensors_launch_nothing():
    counts.reset()
    x = torch.randn(4, 8)
    permute.collective_permute(x, [1, 2, 3, 0])
    permute.pairwise_alltoall(x)
    xla.alltoall(x)
    xla.ring_shift(x)
    assert set(counts["permute_launches"].values()) == {0}


def test_library_path_keyed_by_source():
    p = permute.LIBRARY.path()
    assert p.name.startswith("permute-") and p.suffix == ".so"
    assert p != ring.LIBRARY.path()


def test_xla_reaches_every_pallas_kernel_by_its_jax_name():
    for name in ["pairwise_alltoall", "collective_permute", "ring_attention"]:
        assert callable(getattr(pk, name)) and callable(getattr(xla, name))


# The launch path's table cache: a table is checked and converted once per
# distinct table, bad tables raise every time, and the cache is bounded.

def test_table_cache_gives_the_same_result_twice():
    permute._table.cache_clear()
    x = torch.randn(4, 6)
    first = permute.permute_rows(x, [3, -1, 0, 1])
    again = permute.permute_rows(x, (3, -1, 0, 1))
    assert torch.equal(first, again)
    assert torch.equal(first, permute.permute_rows_plain(x, [3, -1, 0, 1]))
    assert permute._table.cache_info().hits >= 1
    rot = permute.collective_permute(x, [1, 2, 3, 0])
    assert torch.equal(rot, permute.collective_permute(x, [1, 2, 3, 0]))
    assert torch.equal(rot, x.roll(1, 0))


@pytest.mark.parametrize("bad", [[0, 0, 1, 2], [1, 2, 3], [0, 1, 2, 4]])
def test_bad_tables_raise_every_time(bad):
    x = torch.zeros(4, 3)
    for _ in range(2):
        with pytest.raises(ValueError, match="not a permutation"):
            permute.collective_permute(x, bad)
        with pytest.raises(ValueError):
            permute.permute_rows(x, bad if len(bad) != 4 else [0, 1, 2, -2])


def test_table_cache_is_bounded():
    x = torch.zeros(8, 2)
    for i in range(permute.TABLE_CACHE + 20):
        src = [(d + i) % 8 if (i >> d) & 1 else -1 for d in range(8)]
        permute.permute_rows(x, src)
    info = permute._table.cache_info()
    assert info.maxsize == permute.TABLE_CACHE
    assert info.currsize <= permute.TABLE_CACHE
    assert permute._inverse_table.cache_info().maxsize == permute.TABLE_CACHE
