"""tpu_mpi_torch's reduce family against tpu_mpi's, through spmd_run.

The same program runs through both packages on the same numpy inputs, made
from a seed: Allreduce (allocating, mutating, IN_PLACE), Reduce,
Reduce_scatter_block and a custom op, with numpy operands and with tensor
operands (a DeviceBuffer on the CPU in the port, a jax DeviceBuffer in the
reference). The reference runs both with its plain fold and with its Pallas
fold kernel in interpret mode (TPU_MPI_FUSED_FOLD=interp, as
tests/test_pallas_kernels.py does). Tolerance: none — bitwise throughout
(bfloat16 compared as raw bits).
"""

import functools

import numpy as np
import pytest
import torch

import tpu_mpi as JMPI
import tpu_mpi.testing  # noqa: F401  (JMPI.testing.run_spmd)
from tpu_mpi import collective as jcoll
from tpu_mpi import config as jconfig
from tpu_mpi.buffers import DeviceBuffer as JDeviceBuffer

import tpu_mpi_torch as MPI
from tpu_mpi_torch import collective as tcoll
from tpu_mpi_torch import config as tconfig
from tpu_mpi_torch.buffers import to_numpy
from tpu_mpi_torch.kernels import fused_reduce as fr
from tpu_mpi_torch.kernels._build import counts

TIMEOUT = 60


def _data(dtype: str, nranks: int, count: int, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    if dtype.startswith("int"):
        return [rng.integers(-50, 50, count).astype(dtype) for _ in range(nranks)]
    base = "float32" if dtype == "bfloat16" else dtype
    return [rng.standard_normal(count).astype(base) for _ in range(nranks)]


def _jax_make(kind: str, dtype: str):
    import jax.numpy as jnp
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    if kind == "numpy":
        return lambda a: np.array(a)
    return lambda a: JDeviceBuffer(a, dtype=jd)


def _torch_make(kind: str, dtype: str):
    td = torch.bfloat16 if dtype == "bfloat16" else None
    if kind == "numpy":
        return lambda a: np.array(a)
    return lambda a: MPI.DeviceBuffer(a, dtype=td, device="cpu")


def _host(v):
    """A result as numpy, bfloat16 as raw uint16 bits, on either side."""
    if v is None:
        return None
    if isinstance(v, MPI.DeviceBuffer):
        return to_numpy(v.value)
    if isinstance(v, torch.Tensor):
        return to_numpy(v)
    arr = np.asarray(v.value if isinstance(v, JDeviceBuffer) else v)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _program(M, make, flavor: str, op, data: list, repeat: int = 2):
    """``repeat`` identical calls (the reference folds eagerly on the first
    and through its compiled fold from the second); every result kept."""
    count = data[0].size

    def body():
        comm = M.COMM_WORLD
        r = M.Comm_rank(comm)
        size = M.Comm_size(comm)
        outs = []
        for _ in range(repeat):
            x = make(data[r])
            if flavor == "alloc":
                out = M.Allreduce(x, op, comm)
            elif flavor == "mutate":
                out = make(np.zeros_like(data[r]))
                M.Allreduce(x, out, op, comm)
            elif flavor == "inplace":
                M.Allreduce(M.IN_PLACE, x, op, comm)
                out = x
            elif flavor == "reduce":
                out = M.Reduce(x, op, 0, comm)
            elif flavor == "rsb":
                out = make(np.zeros(count // size, dtype=data[r].dtype))
                M.Reduce_scatter_block(x, out, op, comm)
            outs.append(_host(out))
        return outs

    return M.testing.run_spmd(body, len(data), timeout=TIMEOUT)


@pytest.fixture
def jax_fold(request, monkeypatch):
    """The reference's fold: its plain chained fold, or its Pallas kernel in
    interpret mode. Both packages read TPU_MPI_FUSED_FOLD; the port folds
    with its kernel wrapper either way."""
    mode = getattr(request, "param", "plain")
    if mode == "interp":
        monkeypatch.setenv("TPU_MPI_FUSED_FOLD", "interp")
    else:
        monkeypatch.delenv("TPU_MPI_FUSED_FOLD", raising=False)
    jconfig.load(refresh=True)
    tconfig.load(refresh=True)
    with jcoll._fold_lock:
        jcoll._fold_compiled.clear()
        jcoll._fold_seen.clear()
    yield mode
    monkeypatch.delenv("TPU_MPI_FUSED_FOLD", raising=False)
    jconfig.load(refresh=True)
    tconfig.load(refresh=True)


def _both(kind, dtype, flavor, opname, data):
    jop = getattr(JMPI, opname) if isinstance(opname, str) else opname
    top = getattr(MPI, opname) if isinstance(opname, str) else opname
    want = _program(JMPI, _jax_make(kind, dtype), flavor, jop, data)
    got = _program(MPI, _torch_make(kind, dtype), flavor, top, data)
    return want, got


def _assert_same(want, got):
    assert len(want) == len(got)
    for w_rank, g_rank in zip(want, got):
        for w, g in zip(w_rank, g_rank):
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["numpy", "device"])
@pytest.mark.parametrize("flavor", ["alloc", "mutate", "inplace", "reduce",
                                    "rsb"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
def test_reduce_family_matches_reference(kind, flavor, dtype, jax_fold):
    data = _data(dtype, 3, 999 if flavor != "rsb" else 996)
    _assert_same(*_both(kind, dtype, flavor, "SUM", data))


@pytest.mark.parametrize("jax_fold", ["plain", "interp"], indirect=True)
@pytest.mark.parametrize("opname", ["SUM", "PROD", "MAX", "MIN"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_device_ops_match_reference_kernel(opname, dtype, jax_fold):
    data = _data(dtype, 4, 1000, seed=7)
    _assert_same(*_both("device", dtype, "alloc", opname, data))


@pytest.mark.parametrize("kind", ["numpy", "device"])
def test_custom_op_matches_reference(kind, jax_fold):
    data = _data("float64", 3, 257, seed=9)
    _assert_same(*_both(kind, "float64", "alloc", lambda a, b: 2 * a - b,
                        data))


@pytest.mark.parametrize("nranks", [2, 5])
def test_rank_counts(nranks, jax_fold):
    data = _data("float32", nranks, 1 << 14, seed=nranks)
    _assert_same(*_both("device", "float32", "mutate", "SUM", data))


# ---------------------------------------------------------------------------
# Which fold ran
# ---------------------------------------------------------------------------

def _left_fold(arrs, fn=np.add):
    return functools.reduce(fn, arrs)


def test_tensor_folds_take_the_kernel_wrapper(monkeypatch, jax_fold):
    calls = []
    orig = fr.fused_multi_reduce

    def spy(xs, op, **kw):
        calls.append(op)
        return orig(xs, op, **kw)
    monkeypatch.setattr(fr, "fused_multi_reduce", spy)
    data = _data("float32", 4, 64)
    chained0 = counts["chained_folds"]
    got = _program(MPI, _torch_make("device", "float32"), "alloc", MPI.MAX,
                   data, repeat=1)
    assert calls == ["MAX"]
    assert counts["chained_folds"] == chained0
    np.testing.assert_array_equal(got[0][0], _left_fold(data, np.maximum))


@pytest.mark.parametrize("why", ["custom", "off"])
def test_chained_fold_counted(why, monkeypatch, jax_fold):
    if why == "off":
        monkeypatch.setenv("TPU_MPI_FUSED_FOLD", "off")
        tconfig.load(refresh=True)
    op = (lambda a, b: a + b) if why == "custom" else MPI.SUM
    data = _data("float32", 3, 64)
    chained0 = counts["chained_folds"]
    got = _program(MPI, _torch_make("device", "float32"), "alloc", op, data,
                   repeat=1)
    assert counts["chained_folds"] == chained0 + 1
    np.testing.assert_array_equal(got[0][0], _left_fold(data))


# ---------------------------------------------------------------------------
# Persistent and auto-armed lanes
# ---------------------------------------------------------------------------

def test_allreduce_init_rounds_and_slot_validity(jax_fold):
    """Rounds of Allreduce_init on tensor cells: every round's result is
    right, lands in the registration's preallocated slots, and round k's
    result still holds its values after round k+1 (valid until k+2)."""
    nranks, count, rounds = 3, 500, 5
    data = _data("float32", nranks, count, seed=21)

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(data[r], device="cpu")
        z = MPI.DeviceBuffer(np.zeros(count, np.float32), device="cpu")
        req = MPI.Allreduce_init(x, z, MPI.SUM, comm)
        assert req.registration is not None
        prev, got, ptrs = None, [], []
        for k in range(rounds):
            x[:] = torch.from_numpy(data[r] + k)     # copy on write
            MPI.Start(req)
            MPI.Wait(req)
            got.append(to_numpy(z.value))
            ptrs.append(z.value.data_ptr())
            if prev is not None:
                # round k-1's result survives round k
                np.testing.assert_array_equal(to_numpy(prev[1]), prev[0])
            prev = (got[-1].copy(), z.value)
        return got, ptrs

    res = MPI.spmd_run(body, nranks, timeout=TIMEOUT)
    for got, ptrs in res:
        for k in range(rounds):
            want = _left_fold([d + k for d in data])
            np.testing.assert_array_equal(got[k], want)
        assert all(a != b for a, b in zip(ptrs, ptrs[1:]))
        assert len(set(ptrs)) <= 2 * nranks


def test_allreduce_init_matches_reference(jax_fold):
    data = _data("float64", 3, 300, seed=22)

    def program(M, make):
        def body():
            comm = M.COMM_WORLD
            r = M.Comm_rank(comm)
            x = make(data[r])
            z = make(np.zeros_like(data[r]))
            req = M.Allreduce_init(x, z, M.SUM, comm)
            outs = []
            for _ in range(3):
                M.Start(req)
                M.Wait(req)
                outs.append(_host(z))
            return outs
        return M.testing.run_spmd(body, 3, timeout=TIMEOUT)

    _assert_same(program(JMPI, _jax_make("device", "float64")),
                 program(MPI, _torch_make("device", "float64")))


def test_auto_arm_after_repeated_calls(jax_fold):
    """Identical repeated Allreduce calls (same argument objects) arm the
    registered lane after auto_arm_threshold (4) calls; every result stays
    equal to the reference's."""
    calls = 7
    data = _data("float32", 4, 777, seed=23)

    def program(M, make):
        def body():
            comm = M.COMM_WORLD
            r = M.Comm_rank(comm)
            x, y = make(data[r]), make(np.zeros_like(data[r]))
            outs = []
            for _ in range(calls):
                M.Allreduce(x, y, M.SUM, comm)
                outs.append(_host(y))
            return outs
        return M.testing.run_spmd(body, len(data), timeout=TIMEOUT)

    hits0 = tcoll._plans.auto_hits
    got = program(MPI, _torch_make("device", "float32"))
    assert tcoll._plans.auto_hits > hits0
    _assert_same(program(JMPI, _jax_make("device", "float32")), got)
    np.testing.assert_array_equal(got[0][-1], _left_fold(data))


# ---------------------------------------------------------------------------
# Copy on write: one result tensor is shared by every rank's cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", ["alloc", "mutate"])
def test_shared_result_is_copy_on_write(flavor):
    data = _data("float32", 2, 16, seed=24)
    want = _left_fold(data)

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(data[r], device="cpu")
        if flavor == "alloc":
            out = MPI.Allreduce(x, MPI.SUM, comm)
        else:
            out = MPI.DeviceBuffer(np.zeros(16, np.float32), device="cpu")
            MPI.Allreduce(x, out, MPI.SUM, comm)
        before = out.value
        MPI.Barrier(comm)
        if r == 0:
            out[0] = 12345.0
            out.setflat(np.full(3, -1.0, np.float32), 3)
            out.fill(7.0)
        MPI.Barrier(comm)
        return to_numpy(out.value), to_numpy(before)

    (r0, shared0), (r1, shared1) = MPI.spmd_run(body, 2, timeout=TIMEOUT)
    np.testing.assert_array_equal(r0, np.full(16, 7.0, np.float32))
    np.testing.assert_array_equal(r1, want)
    np.testing.assert_array_equal(shared0, want)
    np.testing.assert_array_equal(shared1, want)


# ---------------------------------------------------------------------------
# Collectives whose combine moved from jax.numpy to torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "device"])
def test_gather_family_and_scans_match_reference(kind):
    nranks = 3
    total = nranks * (nranks + 1) // 2 * 4           # Alltoallv send size
    data = _data("float32", nranks, total, seed=25)

    def program(M, make):
        C = M.collective

        def body():
            comm = M.COMM_WORLD
            r = M.Comm_rank(comm)
            x = make(data[r])
            scounts = [4 * (j + 1) for j in range(nranks)]
            rcounts = [4 * (r + 1)] * nranks
            gcounts = [5 + j for j in range(nranks)]
            ex = C.Exscan(x, M.MAX, comm)      # rank 0's result undefined
            return [_host(C.Allgather(x, comm)),
                    _host(C.Allgatherv(make(data[r][:gcounts[r]]), gcounts,
                                       comm)),
                    _host(C.Gatherv(make(data[r][:gcounts[r]]), gcounts, 1,
                                    comm)),
                    _host(C.Alltoall(x, total // nranks, comm)),
                    _host(C.Alltoallv(x, scounts, rcounts, comm)),
                    _host(C.Scan(x, M.SUM, comm)),
                    _host(ex) if r else None]
        return M.testing.run_spmd(body, nranks, timeout=TIMEOUT)

    want = program(JMPI, _jax_make(kind, "float32"))
    got = program(MPI, _torch_make(kind, "float32"))
    _assert_same(want, got)


def test_mixed_host_and_tensor_contributions():
    """One rank contributes numpy, the others CPU tensors: the fold moves
    the host part onto the tensors' device and stays a rank-ordered fold."""
    data = _data("float64", 3, 100, seed=26)

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = np.array(data[r]) if r == 1 else \
            MPI.DeviceBuffer(data[r], device="cpu")
        return _host(MPI.Allreduce(x, MPI.SUM, comm))

    for got in MPI.testing.run_spmd(body, 3, timeout=TIMEOUT):
        np.testing.assert_array_equal(got, _left_fold(data))
