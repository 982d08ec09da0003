"""The port's ring collectives (tpu_mpi_torch.kernels.ring) against the
Pallas kernels they replace (tpu_mpi.xla.pallas_kernels.ring_allreduce,
ring_reduce_scatter, ring_allgather), which run here in interpret mode on
the conftest's 8-device CPU mesh, as tests/test_pallas_kernels.py runs them.

The same numpy inputs, made from a seed, go through both: the JAX kernel
under shard_map with in_specs=P("x"), the port's wrapper on the stacked
(n, ...) CPU tensor, where it runs its plain version (the replayed ring
schedule). Tolerance: none — every case is bitwise (bfloat16 compared as
raw bits). Interpret calls cost seconds each, mostly in compilation, so
all the JAX kernels for one mesh size run as one compiled program.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

import tpu_mpi
import tpu_mpi_torch
from tpu_mpi import xla
from tpu_mpi.xla import pallas_kernels as pk
from tpu_mpi_torch.buffers import from_numpy, to_numpy
from tpu_mpi_torch.kernels import fused_reduce as fr
from tpu_mpi_torch.kernels import ring
from tpu_mpi_torch.kernels._build import counts


def _noncommutative(a, b):
    return 2 * a - b        # 2a is exact, so one rounding, on both sides


_OPS = {
    "sum": ("sum", "sum"),
    "max": ("max", "max"),
    "min": ("min", "min"),
    "PROD": (tpu_mpi.PROD, tpu_mpi_torch.PROD),
    "callable": (_noncommutative, _noncommutative),
}

# (n, kernel, dtype, per-rank count, op). 8229 elements at n=4 fill three
# ring chunks of 3072 and leave the fourth as padding; 40 fits in chunk 0.
CASES = [
    (4, "allreduce", "float32", 8229, "sum"),
    (4, "allreduce", "float32", 8229, "max"),
    (4, "allreduce", "float32", 8229, "min"),
    (4, "allreduce", "float32", 8229, "PROD"),
    (4, "allreduce", "float32", 8229, "callable"),
    (4, "allreduce", "float32", 40, "sum"),
    (4, "allreduce", "bfloat16", 8229, "sum"),
    (4, "allreduce", "int32", 8229, "PROD"),
    (4, "reduce_scatter", "float32", 4 * 3000, "sum"),
    (4, "reduce_scatter", "float32", 4 * 3000, "min"),
    (4, "reduce_scatter", "float32", 4 * 3000, "callable"),
    (4, "reduce_scatter", "bfloat16", 4 * 3000, "sum"),
    (4, "reduce_scatter", "int32", 4 * 3000, "max"),
    (4, "allgather", "float32", 30, None),
    (8, "allreduce", "float32", 8229, "sum"),
    (8, "allreduce", "float32", 40, "max"),
    (8, "reduce_scatter", "float32", 4 * 3000, "sum"),
    (8, "allgather", "bfloat16", 30, None),
    # unsigned types, with values that wrap (torch folds them through the
    # signed views; the kernels take them as types of their own)
    (4, "allreduce", "uint16", 8229, "sum"),
    (4, "allreduce", "uint64", 8229, "min"),
    (4, "allreduce", "uint32", 8229, "max"),
    (4, "reduce_scatter", "uint32", 4 * 3000, "max"),
    (4, "reduce_scatter", "uint64", 4 * 3000, "min"),
    (4, "reduce_scatter", "uint16", 4 * 3000, "sum"),
    (8, "reduce_scatter", "uint32", 4 * 3000, "sum"),
    (4, "allgather", "uint16", 30, None),
]


def _case_id(case):
    n, kernel, dtype, count, op = case
    return f"n{n}-{kernel}-{dtype}-{count}-{op}"


def _inputs(case) -> np.ndarray:
    """(n, count) seeded inputs; floats at mixed magnitudes so that the
    order of a float fold shows in the bits."""
    n, _, dtype, count, _ = case
    rng = np.random.default_rng(CASES.index(case) + 100)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (n, count)).astype(np.int32)
    if dtype.startswith("uint"):      # the top half of the range, and 0-3
        top = np.iinfo(dtype).max
        high = rng.integers(top // 2, top, (n, count), dtype=dtype, endpoint=True)
        low = rng.integers(0, 4, (n, count), dtype=dtype)
        return np.where(rng.integers(0, 2, (n, count)).astype(bool), high, low)
    mag = 10.0 ** rng.integers(-4, 5, (n, count))
    return (rng.standard_normal((n, count)) * mag).astype(np.float32)


def _bits(a: np.ndarray, dtype: str) -> np.ndarray:
    return a.view(np.uint16) if dtype == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _jax_results(n: int) -> dict:
    """Every case of mesh size n through the Pallas kernels, in one
    compiled program; results reshaped to the port's stacked form."""
    cases = [c for c in CASES if c[0] == n]
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    mesh = xla.make_mesh({"x": n})

    def body(*vs):
        outs = []
        for (_, kernel, _, _, op), v in zip(cases, vs):
            if kernel == "allreduce":
                outs.append(pk.ring_allreduce(v, _OPS[op][0], axis="x"))
            elif kernel == "reduce_scatter":
                outs.append(pk.ring_reduce_scatter(v, _OPS[op][0], axis="x"))
            else:
                outs.append(pk.ring_allgather(v, axis="x"))
        return tuple(outs)

    specs = tuple(P("x") for _ in cases)
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=specs,
                              out_specs=specs, check_vma=False))
    args = []
    for c in cases:
        jd = jnp.bfloat16 if c[2] == "bfloat16" else c[2]
        args.append(jnp.asarray(_inputs(c).reshape(-1), dtype=jd))
    outs = f(*args)
    res = {}
    for c, out in zip(cases, outs):
        out = _bits(np.asarray(out), c[2])
        if c[1] == "allgather":
            res[c] = out.reshape(n, n, c[3])
        else:
            res[c] = out.reshape(n, -1)
    return res


def _port(case) -> np.ndarray:
    _, kernel, dtype, _, op = case
    xs = from_numpy(_inputs(case), "cpu")
    if dtype == "bfloat16":
        xs = xs.to(torch.bfloat16)
    if kernel == "allreduce":
        out = ring.ring_allreduce(xs, _OPS[op][1])
    elif kernel == "reduce_scatter":
        out = ring.ring_reduce_scatter(xs, _OPS[op][1])
    else:
        out = ring.ring_allgather(xs)
    assert out.device.type == "cpu" and out.dtype == xs.dtype
    return to_numpy(out)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_ring_matches_pallas_kernel(case):
    want = _jax_results(case[0])[case]
    got = _port(case)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_left_fold_is_not_the_ring_allreduce():
    # Guards against a port that reuses the rank-ordered fused fold: at
    # 8229 elements the ring folds chunks 1 and 2 from ranks 1 and 2, and
    # float sums in another order differ in the last bits.
    case = CASES[0]
    ring_out = _jax_results(4)[case][0]
    xs = [torch.from_numpy(row) for row in _inputs(case)]
    left = fr.fused_multi_reduce(xs, "SUM").numpy()
    chunk = ring.chunk_elems(case[3], 4)
    assert not np.array_equal(left, ring_out)
    # chunk 0 starts its fold at rank 0: that chunk IS the left fold
    np.testing.assert_array_equal(left[:chunk], ring_out[:chunk])


def test_fsdp_round_trip_is_not_the_ring_allreduce():
    # reduce-scatter block c folds from rank c+1, allreduce chunk c from
    # rank c: at 4 x 32768 chunks and blocks coincide, the start ranks do not
    n, count = 4, 4 * 8192
    rng = np.random.default_rng(20261016)
    xs = torch.from_numpy(rng.standard_normal((n, count), dtype=np.float32))
    ar = ring.ring_allreduce(xs, "sum")[0]
    trip = ring.ring_allgather(ring.ring_reduce_scatter(xs, "sum"))
    trip = trip.reshape(n, -1)[0]
    left = fr.fused_multi_reduce(list(xs), "SUM")
    assert ring.chunk_elems(count, n) == count // n
    assert not torch.equal(ar, trip)
    assert torch.equal(trip[-count // n:], left[-count // n:])   # block n-1
    assert not torch.equal(trip, left)


def test_every_rank_gets_the_same_allreduce():
    xs = from_numpy(_inputs(CASES[0]), "cpu")
    out = ring.ring_allreduce(xs, "sum")
    assert all(torch.equal(out[0], out[r]) for r in range(4))


@pytest.mark.parametrize("count,n", [(8229, 4), (40, 4), (1, 2), (127, 5),
                                     (4097, 8)])
def test_plain_allreduce_is_the_ring_order_fold(count, n):
    # element e of chunk c folds from rank c: x[c-1] + (... + (x[c+1] + x[c]))
    rng = np.random.default_rng(count + n)
    x = (rng.standard_normal((n, count))
         * 10.0 ** rng.integers(-4, 5, (n, count))).astype(np.float32)
    chunk = ring.chunk_elems(count, n)
    want = np.empty(count, np.float32)
    for e in range(count):
        c = e // chunk
        acc = x[c, e]
        for k in range(1, n):
            acc = np.float32(x[(c + k) % n, e] + acc)
        want[e] = acc
    got = ring.ring_allreduce(torch.from_numpy(x), "sum")
    np.testing.assert_array_equal(got.numpy()[n - 1], want)


def test_plain_reduce_scatter_is_the_ring_order_fold():
    # block c folds from rank c+1: x[c] + (... + (x[c+2] + x[c+1]))
    n, per = 5, 7
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((n, n * per))
         * 10.0 ** rng.integers(-4, 5, (n, n * per))).astype(np.float32)
    got = ring.ring_reduce_scatter(torch.from_numpy(x), tpu_mpi_torch.SUM)
    for c in range(n):
        acc = x[(c + 1) % n, c * per:(c + 1) * per]
        for k in range(2, n + 1):
            acc = x[(c + k) % n, c * per:(c + 1) * per] + acc
        np.testing.assert_array_equal(got.numpy()[c], acc)


def test_one_rank_returns_what_the_tpu_wrappers_return():
    xs = torch.arange(6.0).reshape(1, 2, 3)
    assert ring.ring_allreduce(xs, "sum") is xs
    assert ring.ring_reduce_scatter(xs, "sum").shape == (1, 6)
    assert ring.ring_allgather(xs).shape == (1, 1, 2, 3)


def test_ops_are_chosen_up_front():
    assert ring._combine_fn("max")[0] == "MAX"
    assert ring._combine_fn(tpu_mpi_torch.BXOR)[0] == "BXOR"
    assert ring._combine_fn(max)[0] == "MAX"           # builtin -> MAX
    assert ring._combine_fn(tpu_mpi_torch.LAND)[0] is None
    assert ring._combine_fn(_noncommutative)[0] is None
    with pytest.raises(ValueError, match="unsupported ring op"):
        ring._combine_fn("mean")


def test_callable_rings_are_counted_and_launch_nothing():
    xs = torch.arange(8.0).reshape(2, 4)
    counts.reset()
    ring.ring_allreduce(xs, _noncommutative)
    ring.ring_reduce_scatter(xs, tpu_mpi_torch.LOR)
    ring.ring_allreduce(xs, "sum")                     # CPU: plain, no count
    assert counts["callable_rings"] == 2
    assert set(counts["ring_launches"].values()) == {0}


@pytest.mark.parametrize("bad", ["scalar", "no ranks", "indivisible",
                                 "not a tensor"])
def test_wrappers_refuse(bad):
    with pytest.raises((ValueError, TypeError)):
        if bad == "scalar":
            ring.ring_allreduce(torch.tensor(1.0), "sum")
        elif bad == "no ranks":
            ring.ring_allgather(torch.zeros(0, 4))
        elif bad == "indivisible":
            ring.ring_reduce_scatter(torch.zeros(4, 10), "sum")
        else:
            ring.ring_allreduce(np.zeros((2, 3)), "sum")


def test_library_path_keyed_by_source():
    p = ring.LIBRARY.path()
    assert p.name.startswith("ring-") and p.suffix == ".so"
    assert ring.LIBRARY.path() == p != fr.LIBRARY.path()
