"""Folds of uint16, uint32 and uint64 in the port against the JAX package.

torch has no add, compare or logical kernels for these three types, on the
CPU as on the card; the port's reduction operators fold them through the
signed view of the same width and its kernels take them as types of their
own. Every fold route is held here to the JAX package, bitwise, on the
same numpy inputs made from a seed and chosen to wrap (half of the values
in the top half of the range, the rest 0-3, so SUM and PROD overflow, MAX
and MIN see the top bit, and LAND and LOR see zeros):

- the host reduce family (Allreduce, Reduce, Reduce_scatter, Scan, Exscan)
  with numpy, ``DeviceBuffer`` and raw-tensor operands in each test (the
  JAX package's numpy and jax ``DeviceBuffer`` operands beside them);
- ``Accumulate`` and ``Fetch_and_op`` on windows of the same kinds;
- ``xla.allreduce`` and ``xla.reduce_scatter`` under shard_map;
- the fused fold kernel's plain version against the Pallas kernel in
  interpret mode (the ring kernels' unsigned cases are in
  tests/test_torch_ring.py; the kernels themselves on the card in
  tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import tpu_mpi as JMPI
from tpu_mpi import xla as jxla
from tpu_mpi.xla import pallas_kernels as pk

import tpu_mpi_torch as MPI
from tpu_mpi_torch import xla
from tpu_mpi_torch.buffers import from_numpy, to_numpy
from tpu_mpi_torch.kernels import fused_reduce as fr

from test_torch_p2p import KINDS, assert_parity, host

DTYPES = ["uint16", "uint32", "uint64"]
OPS = ["SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR", "LAND", "LOR"]
KERNEL_OPS = OPS[:7]            # the predefined ops the kernels implement
NPROCS = 4
COUNT = 12                      # elements a rank; splits over NPROCS


def wrapping(dtype: str, shape: tuple, seed: int) -> np.ndarray:
    """Half the values in the top half of the type's range, half 0-3."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    high = rng.integers(top // 2, top, shape, dtype=dtype, endpoint=True)
    low = rng.integers(0, 4, shape, dtype=dtype)
    return np.where(rng.integers(0, 2, shape).astype(bool), high, low)


def _seed(dtype: str) -> int:
    return 20 + DTYPES.index(dtype)


# ---------------------------------------------------------------------------
# The host reduce family
# ---------------------------------------------------------------------------

def p_reduce_family(M, AT, data, dtype):
    def body():
        comm = M.COMM_WORLD
        r, n = M.Comm_rank(comm), M.Comm_size(comm)
        outs = {}
        for name in OPS:
            op = getattr(M, name)
            x = AT.array(data[r])
            outs[name, "allreduce"] = host(M.Allreduce(x, op, comm))
            y = AT.zeros((COUNT,), dtype=dtype)
            M.Allreduce(x, y, op, comm)
            outs[name, "allreduce into"] = host(y)
            red = M.Reduce(x, op, 0, comm)
            outs[name, "reduce"] = host(red) if r == 0 else None
            part = AT.zeros((COUNT // n,), dtype=dtype)
            M.Reduce_scatter(x, part, [COUNT // n] * n, op, comm)
            outs[name, "reduce_scatter"] = host(part)
            outs[name, "scan"] = host(M.Scan(x, op, comm))
            ex = M.Exscan(x, op, comm)
            outs[name, "exscan"] = host(ex) if r > 0 else None
        return outs
    return body


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_reduce_family(dtype):
    data = wrapping(dtype, (NPROCS, COUNT), _seed(dtype))
    assert (data.astype(object).sum(0) > np.iinfo(dtype).max).any()
    assert (data == 0).any()
    for kind in KINDS:
        got = assert_parity(p_reduce_family, kind, NPROCS, data=data, dtype=dtype)
        assert got[0]["SUM", "allreduce"].dtype == np.dtype(dtype), kind


# ---------------------------------------------------------------------------
# One-sided: Accumulate and Fetch_and_op
# ---------------------------------------------------------------------------

def p_accumulate(M, AT, data, dtype):
    """Every rank accumulates its row into rank 0's window under each op
    (the ops commute and associate on integers, so the arrival order does
    not show), then fetches-and-ops its own element of rank 1's window."""
    def body():
        comm = M.COMM_WORLD
        r = M.Comm_rank(comm)
        outs = {}
        for name in OPS:
            op = getattr(M, name)
            buf = AT.array(data[r])
            win = M.Win_create(buf, comm)
            M.Win_fence(0, win)
            M.Accumulate(AT.array(data[(r + 1) % NPROCS]), COUNT, 0, 0, op, win)
            M.Win_fence(0, win)
            outs[name, "accumulate"] = host(buf) if r == 0 else None
            M.Barrier(comm)
            fetched = AT.zeros((1,), dtype=dtype)
            M.Win_lock(M.LOCK_EXCLUSIVE, 1, 0, win)
            M.Fetch_and_op(AT.array(data[r][-1:]), fetched, 1, r, op, win)
            M.Win_unlock(1, win)
            M.Barrier(comm)
            outs[name, "fetched"] = host(fetched)
            outs[name, "window"] = host(buf) if r == 1 else None
            M.Barrier(comm)
            win.free()
        return outs
    return body


@pytest.mark.parametrize("dtype", DTYPES)
def test_accumulate_and_fetch_and_op(dtype):
    data = wrapping(dtype, (NPROCS, COUNT), _seed(dtype) + 10)
    for kind in KINDS:
        assert_parity(p_accumulate, kind, NPROCS, data=data, dtype=dtype)


# ---------------------------------------------------------------------------
# The in-graph tier
# ---------------------------------------------------------------------------

N = 8


@pytest.fixture(scope="module")
def jmesh():
    return jxla.make_mesh({"x": N})


def _jax(jmesh, fn, stacked):
    f = jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=P("x"),
                              out_specs=P("x")))
    return np.asarray(f(jnp.asarray(stacked.reshape(-1))))


@pytest.mark.parametrize("dtype", DTYPES)
def test_xla_allreduce_and_reduce_scatter(jmesh, dtype):
    x = wrapping(dtype, (N, 2 * N), _seed(dtype) + 20)
    for name in OPS:
        jop, top = getattr(JMPI, name), getattr(MPI, name)
        want = _jax(jmesh, lambda v: jxla.allreduce(v, jop, axis="x"), x)
        got = xla.allreduce(from_numpy(x, "cpu"), top)
        np.testing.assert_array_equal(to_numpy(got), want.reshape(N, 2 * N))
        assert got.dtype == from_numpy(x, "cpu").dtype, name
        want = _jax(jmesh, lambda v: jxla.reduce_scatter(v, jop, axis="x"), x)
        got = to_numpy(xla.reduce_scatter(from_numpy(x, "cpu"), top))
        np.testing.assert_array_equal(got, want.reshape(got.shape))


# ---------------------------------------------------------------------------
# The fused fold against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_fold_matches_pallas_kernel(dtype):
    arrs = list(wrapping(dtype, (5, 1000), _seed(dtype) + 30))
    for name in KERNEL_OPS:
        want = np.asarray(pk.fused_multi_reduce(
            [jnp.asarray(a) for a in arrs], getattr(JMPI, name), interpret=True))
        got = to_numpy(fr.fused_multi_reduce([from_numpy(a, "cpu") for a in arrs],
                                             name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.uint32, torch.uint64])
def test_kernels_take_the_unsigned_types(dtype):
    for name in KERNEL_OPS:
        assert fr.supports(name, dtype)
