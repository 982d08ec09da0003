"""tpu_mpi_torch's one-sided RMA against tpu_mpi's.

Every case of tests/test_onesided.py is one SPMD program, written once
against a package ``M`` and an array factory ``AT``, run through both
packages as in tests/test_torch_p2p.py over the ``numpy``,
``devicebuffer`` and ``tensor`` kinds; each run asserts the reference
test's own checks, and the port's per-rank results are held to the JAX
package's bitwise.

Beyond them: ``Get_address`` on tensors and cells (the dynamic-window
address rule), Accumulate on tensor windows as the fold of
``operators.acc_combine`` (REPLACE, NO_OP, predefined ops through the
fold's candidate check, custom ops counted as chained folds), windows over
raw tensors written in place, origins and results that overlap the target
range in part (numpy's rule: the source is read in full first), the CPU
device rule of
``Win_allocate_shared``, and the multi-process branch that raises.
"""

import types

import numpy as np
import pytest
import torch

import tpu_mpi as JMPI
import tpu_mpi_torch as MPI
from tpu_mpi_torch.kernels._build import counts

from test_torch_p2p import KINDS, TIMEOUT, assert_parity, host

SEED = 8


def _fill(buf, v):
    if isinstance(buf, torch.Tensor):
        buf.fill_(v)
    else:
        buf.fill(v)


# ---------------------------------------------------------------------------
# tests/test_onesided.py
# ---------------------------------------------------------------------------

def p_get_fence(M, AT):
    """Fence-epoch Get from the right neighbour (test_onesided.jl:17-23)."""
    def body():
        comm = M.COMM_WORLD
        rank, N = M.Comm_rank(comm), M.Comm_size(comm)
        buf = AT.full((N,), rank, dtype=np.int64)
        received = AT.full((N,), -1, dtype=np.int64)
        win = M.Win_create(buf, comm)
        M.Win_fence(0, win)
        M.Get(received, (rank + 1) % N, win)
        M.Win_fence(0, win)
        assert M.testing.aeq(received, np.full(N, (rank + 1) % N))
        M.Barrier(comm)
        win.free()
        return host(received)
    return body


def p_put_locked(M, AT):
    """Locked-window Put into rank 0 (test_onesided.jl:25-39)."""
    def body():
        comm = M.COMM_WORLD
        rank, N = M.Comm_rank(comm), M.Comm_size(comm)
        buf = AT.full((N,), rank, dtype=np.int64)
        win = M.Win_create(buf, comm)
        M.Win_lock(M.LOCK_EXCLUSIVE, 0, 0, win)
        if rank != 0:
            M.Put(AT.full((1,), rank, dtype=np.int64), 1, 0, rank, win)
        else:
            buf[0] = 0
        M.Win_unlock(0, win)
        M.Win_fence(0, win)
        out = host(buf)
        if rank == 0:
            assert M.testing.aeq(buf, np.arange(N))
        M.Barrier(comm)
        return out
    return body


def p_accumulate_get_accumulate(M, AT):
    """Accumulate / Get_accumulate atomicity (test_onesided.jl:43-83)."""
    def body():
        comm = M.COMM_WORLD
        rank, N = M.Comm_rank(comm), M.Comm_size(comm)
        buf = AT.zeros((4,), dtype=np.int64)
        win = M.Win_create(buf, comm)
        M.Win_fence(0, win)
        M.Accumulate(AT.full((4,), rank + 1, dtype=np.int64), 4, 0, 0, M.SUM, win)
        M.Win_fence(0, win)
        if rank == 0:
            assert M.testing.aeq(buf, np.full(4, N * (N + 1) // 2))
        summed = host(buf)
        M.Barrier(comm)
        if rank == 1:
            _fill(buf, 3)
        M.Barrier(comm)
        fetched = None
        if rank == 0:
            origin = AT.full((4,), 2, dtype=np.int64)
            result = AT.zeros((4,), dtype=np.int64)
            M.Win_lock(M.LOCK_EXCLUSIVE, 1, 0, win)
            M.Get_accumulate(origin, result, 4, 1, 0, M.SUM, win)
            M.Win_unlock(1, win)
            assert M.testing.aeq(result, np.full(4, 3))
            fetched = host(result)
        M.Barrier(comm)
        if rank == 1:
            assert M.testing.aeq(buf, np.full(4, 5))
        M.Barrier(comm)
        return summed, fetched, host(buf)
    return body


def p_fetch_and_op_dynamic(M, AT):
    """Dynamic window + byte addressing + Fetch_and_op REPLACE
    (test_onesided.jl:89-124)."""
    def body():
        comm = M.COMM_WORLD
        rank, N = M.Comm_rank(comm), M.Comm_size(comm)
        buf = AT.full(N, rank, dtype=np.int64)
        win = M.Win_create_dynamic(comm)
        M.Win_attach(win, buf)
        address_buf = np.zeros(1, dtype=np.int64)
        address_win = M.Win_create(address_buf, comm)
        M.Win_lock(M.LOCK_EXCLUSIVE, rank, 0, address_win)
        address_buf[0] = M.Get_address(buf)
        M.Win_unlock(rank, address_win)
        M.Barrier(comm)
        seen = []
        if rank == 0:
            received = AT.zeros(1, dtype=np.int64)
            to_send = np.zeros(1, dtype=np.int64)
            for r in range(N):
                address = np.zeros(1, dtype=np.int64)
                M.Win_lock(M.LOCK_EXCLUSIVE, r, 0, address_win)
                M.Get(address, r, address_win)
                M.Win_flush(r, address_win)
                to_send[0] = r + 5
                M.Win_lock(M.LOCK_EXCLUSIVE, r, 0, win)
                M.Fetch_and_op(to_send, received, r, int(address[0]) + r * 8,
                               M.REPLACE, win)
                M.Win_flush(r, win)
                assert host(received)[0] == r
                seen.append(int(host(received)[0]))
                M.Win_unlock(r, win)
                M.Win_unlock(r, address_win)
        M.Barrier(comm)
        assert host(buf)[rank] == rank + 5
        M.Barrier(comm)
        M.Win_detach(win, buf)
        win.free()
        address_win.free()
        return seen, host(buf)
    return body


def _grid(shared):
    """The (100, 2) view of a shared slab that writes through to it."""
    if isinstance(shared, torch.Tensor):
        return shared.view(100, 2)
    return np.asarray(shared).reshape(100, 2)


def p_shared_window(M, AT):
    """Node-shared allocation + query (reference: test/test_shared_win.jl);
    the slab is the package's own kind (a tensor in the port).
    ``device="cpu"`` is the port's device rule; the JAX package takes it as
    an Info hint."""
    def body():
        comm = M.COMM_WORLD
        rank, N = M.Comm_rank(comm), M.Comm_size(comm)
        owner = min(1, N - 1)
        length = 100 * 2 if rank == owner else 0
        win, local = M.Win_allocate_shared(np.float32, length, comm, device="cpu")
        size_bytes, disp_unit, shared = M.Win_shared_query(win, owner)
        assert disp_unit == 4
        assert size_bytes == 200 * 4
        arr = _grid(shared)
        col = (lambda a: torch.from_numpy(a)) if isinstance(arr, torch.Tensor) \
            else (lambda a: a)
        if rank == 0:
            arr[:, 0] = col(np.arange(1, 101, dtype=np.float32))
        elif rank == 1:
            arr[:, 1] = col(np.arange(901, 1001, dtype=np.float32))
        M.Barrier(comm)
        assert M.testing.aeq(arr[:, 0], np.arange(1, 101))
        if N > 1:
            assert M.testing.aeq(arr[:, 1], np.arange(901, 1001))
        out = host(arr)
        M.Barrier(comm)
        win.free()
        return out
    return body


def p_lock_mutual_exclusion(M, AT):
    """Exclusive locks serialize concurrent read-modify-write."""
    def body():
        comm = M.COMM_WORLD
        rank, N = M.Comm_rank(comm), M.Comm_size(comm)
        buf = AT.zeros(1, dtype=np.int64)
        win = M.Win_create(buf, comm)
        M.Win_fence(0, win)
        for _ in range(25):
            M.Win_lock(M.LOCK_EXCLUSIVE, 0, 0, win)
            tmp = AT.zeros(1, dtype=np.int64)
            M.Get(tmp, 1, 0, 0, win)
            tmp[0] += 1
            M.Put(tmp, 1, 0, 0, win)
            M.Win_unlock(0, win)
        M.Barrier(comm)
        if rank == 0:
            assert host(buf)[0] == 25 * N
        M.Barrier(comm)
        return host(buf)
    return body


def p_concurrent_puts_distinct_slots(M, AT):
    """Concurrent Puts into DISTINCT slots of one target are legal inside a
    fence epoch and must all land (a DeviceBuffer target rebinds its whole
    cell per write, so writers are serialized under the per-target mutex)."""
    def body():
        comm = M.COMM_WORLD
        rank, N = M.Comm_rank(comm), M.Comm_size(comm)
        buf = AT.zeros(N, dtype=np.float32)
        win = M.Win_create(buf, comm)
        M.Win_fence(0, win)
        for t in range(N):
            M.Put(np.array([rank + 1.0], np.float32), 1, t, rank, win)
        M.Win_fence(0, win)
        assert M.testing.aeq(buf, np.arange(1, N + 1, dtype=np.float32))
        M.Barrier(comm)
        win.free()
        return host(buf)
    return body


def p_lazy_epoch_semantics(M, AT):
    """Passive-target epochs: a write-only epoch, a read inside an epoch
    that sees the epoch's own Put, a long epoch, a flush inside one."""
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        target = AT.zeros(64, dtype=np.float64)
        win = M.Win_create(target, comm)
        if rank == 0:
            M.Win_lock(M.LOCK_EXCLUSIVE, 1, 0, win)
            M.Put(np.full(4, 5.0), 4, 1, 0, win)
            M.Accumulate(np.full(4, 2.0), 4, 1, 0, M.SUM, win)
            M.Win_unlock(1, win)
            got = AT.zeros(4)
            M.Win_lock(M.LOCK_EXCLUSIVE, 1, 0, win)
            M.Put(np.full(4, 9.0), 4, 1, 8, win)
            M.Get(got, 4, 1, 8, win)
            M.Win_unlock(1, win)
            assert np.all(host(got) == 9.0)
            M.Win_lock(M.LOCK_EXCLUSIVE, 1, 0, win)
            for i in range(24):
                M.Put(np.full(1, float(i)), 1, 1, 16 + i, win)
            M.Win_unlock(1, win)
            M.Win_lock(M.LOCK_EXCLUSIVE, 1, 0, win)
            M.Put(np.full(1, 77.0), 1, 1, 63, win)
            M.Win_flush(1, win)
            M.Win_unlock(1, win)
        M.Barrier(comm)
        t = host(target)
        if rank == 1:
            assert np.all(t[0:4] == 7.0)
            assert np.all(t[8:12] == 9.0)
            assert np.array_equal(t[16:40], np.arange(24.0))
            assert float(t[63]) == 77.0
        M.Barrier(comm)
        win.free()
        return t
    return body


AT_CASES = [p_get_fence, p_put_locked, p_accumulate_get_accumulate,
            p_fetch_and_op_dynamic, p_lock_mutual_exclusion,
            p_concurrent_puts_distinct_slots, p_lazy_epoch_semantics]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("program", AT_CASES, ids=lambda p: p.__name__[2:])
def test_parity(program, kind, nprocs):
    assert_parity(program, kind, nprocs)


def test_shared_window_parity(nprocs):
    assert_parity(p_shared_window, "numpy", nprocs)


# ---------------------------------------------------------------------------
# Accumulate on tensor windows
# ---------------------------------------------------------------------------

def _custom(a, b):
    return a * 2 + b


def p_accumulate_ops(M, AT, dtype, op_name):
    """One origin per fence epoch (a fixed order of origins, so float
    results have fixed bits) under ``op_name``, then Get_accumulate and
    Fetch_and_op of the same op; the window's final values and every
    fetched value come back."""
    def body():
        comm = M.COMM_WORLD
        rank, N = M.Comm_rank(comm), M.Comm_size(comm)
        op = M.Op(_custom) if op_name == "custom" else getattr(M, op_name)
        rng = np.random.default_rng(SEED)
        start = rng.standard_normal(16) * 8
        origins = rng.standard_normal((N, 16)) * 8
        buf = AT.array(start.astype(dtype))
        win = M.Win_create(buf, comm)
        M.Win_fence(0, win)
        for r in range(N):
            if r == rank:
                M.Accumulate(AT.array(origins[r].astype(dtype)), 16, 0, 0, op, win)
            M.Win_fence(0, win)
        fetched = AT.zeros(5, dtype=dtype)
        one = AT.zeros(1, dtype=dtype)
        if rank == 1:
            M.Win_lock(M.LOCK_EXCLUSIVE, 0, 0, win)
            M.Get_accumulate(AT.array(origins[0][:5].astype(dtype)), fetched, 5,
                             0, 3, op, win)
            M.Fetch_and_op(AT.array(origins[1][:1].astype(dtype)), one, 0, 15,
                           op, win)
            M.Win_unlock(0, win)
        M.Win_fence(0, win)
        out = host(buf), host(fetched), host(one)
        M.Barrier(comm)
        win.free()
        return out
    return body


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dtype,op_name", [
    (np.float32, "SUM"), (np.float64, "PROD"), (np.float32, "MAX"),
    (np.int32, "MIN"), (np.int64, "BXOR"), (np.float32, "REPLACE"),
    (np.int32, "NO_OP"), (np.float64, "custom")])
def test_accumulate_op_parity(kind, dtype, op_name, nprocs):
    before = counts["chained_folds"]
    assert_parity(p_accumulate_ops, kind, nprocs, dtype=dtype, op_name=op_name)
    chained = counts["chained_folds"] - before
    custom_on_tensors = op_name == "custom" and kind != "numpy"
    # per rank one Accumulate; rank 1 adds a Get_accumulate and a Fetch_and_op
    assert chained == ((nprocs + 2) if custom_on_tensors else 0)


def test_accumulate_folds_in_place_into_a_raw_tensor_window():
    """A raw tensor window is folded in place: its storage is kept, only
    the target range changes, and a Get_accumulate snapshot is a copy."""
    def body():
        comm = MPI.COMM_WORLD
        rank = MPI.Comm_rank(comm)
        buf = torch.arange(8, dtype=torch.float32)
        ptr = buf.data_ptr()
        win = MPI.Win_create(buf, comm)
        MPI.Win_fence(0, win)
        old = torch.zeros(3)
        if rank == 0:
            MPI.Get_accumulate(torch.ones(3), old, 3, 1, 2, MPI.SUM, win)
        MPI.Win_fence(0, win)
        win.free()
        return buf.data_ptr() == ptr, buf.tolist(), old.tolist()

    out = MPI.testing.run_spmd(body, 2, timeout=TIMEOUT)
    assert out[0] == (True, list(range(8)), [2.0, 3.0, 4.0])
    assert out[1] == (True, [0, 1, 3, 4, 5, 5, 6, 7], [0.0] * 3)


def test_devicebuffer_window_rebinds_and_get_copies():
    """A DeviceBuffer window rebinds on Put; a Get into a cell copies the
    range, so writing the cell never reaches the window."""
    def body():
        comm = MPI.COMM_WORLD
        rank = MPI.Comm_rank(comm)
        buf = MPI.DeviceBuffer(np.zeros(4, np.float32), device="cpu")
        before = buf.value
        win = MPI.Win_create(buf, comm)
        MPI.Win_fence(0, win)
        if rank == 1:
            MPI.Put(torch.ones(2), 2, 0, 1, win)
        MPI.Win_fence(0, win)
        got = MPI.DeviceBuffer(np.zeros(4, np.float32), device="cpu")
        MPI.Get(got, 0, win)
        MPI.Win_fence(0, win)
        got[0] += 9.0        # __getitem__ gives a view: += writes through it
        MPI.Win_fence(0, win)
        win.free()
        return buf.value is before, before.tolist(), buf.value.tolist()

    out = MPI.testing.run_spmd(body, 2, timeout=TIMEOUT)
    assert out[0] == (False, [0.0] * 4, [0.0, 1.0, 1.0, 0.0])
    assert out[1] == (True, [0.0] * 4, [0.0] * 4)


def test_window_over_non_contiguous_tensor_raises_up_front():
    def body():
        with pytest.raises(MPI.MPIError, match="contiguous"):
            MPI.Win_create(torch.zeros(4, 2)[:, 0], MPI.COMM_WORLD)
        win = MPI.Win_create_dynamic(MPI.COMM_WORLD)
        with pytest.raises(MPI.MPIError, match="contiguous"):
            MPI.Win_attach(win, torch.zeros(4, 2)[:, 1])
        win.free()

    MPI.testing.run_spmd(body, 1, timeout=TIMEOUT)


def test_shared_window_goes_to_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def body():
        with pytest.raises(MPI.MPIError, match='device="cpu"'):
            MPI.Win_allocate_shared(np.float32, 4, MPI.COMM_WORLD)
        win, local = MPI.Win_allocate_shared(np.int16, 4, MPI.COMM_WORLD,
                                             device="cpu")
        assert local.dtype == torch.int16 and local.device.type == "cpu"
        win.free()

    MPI.testing.run_spmd(body, 1, timeout=TIMEOUT)


def test_proc_mode_raises(monkeypatch):
    """Windows across OS processes route through the wire engine
    (``_rma_wire``), not the thread tier's shared state; a shared window
    across processes is host shared memory, so asking for it on the card
    raises (the multi-process cases run in tests/test_torch_procs_rma.py)."""
    from tpu_mpi_torch import _rma_wire
    calls = []

    def create(comm, base, disp_unit, opname, dynamic=False, shm_meta=None):
        calls.append((opname.split("@")[0], disp_unit, dynamic))
        return types.SimpleNamespace(is_proc=True, freed=False)

    monkeypatch.setattr(_rma_wire, "create_proc_window", create)
    comm = types.SimpleNamespace(
        cid=5, ctx=types.SimpleNamespace(supports_shared_objects=False))
    MPI.Win_create(np.zeros(2), comm)
    MPI.Win_create(torch.zeros(3, dtype=torch.int16), comm)
    MPI.Win_create_dynamic(comm)
    assert calls == [("Win_create", 8, False), ("Win_create", 2, False),
                     ("Win_create_dynamic", None, True)]
    with pytest.raises(MPI.MPIError, match='device="cpu"'):
        MPI.Win_allocate_shared(np.float32, 2, comm)


# ---------------------------------------------------------------------------
# Origins and results that overlap the target range
# ---------------------------------------------------------------------------

OVERLAP_OPS = ["Accumulate-SUM", "Accumulate-MAX", "Accumulate-REPLACE",
               "Get_accumulate-SUM", "Get_accumulate-REPLACE", "Put", "Get"]


def p_overlapping_origin(M, AT, op, shift):
    """Rank 0 aims one operation at its own window (float32 0..7) in one
    fence epoch: the origin views the window's first four elements and the
    target range starts at ``shift`` (Get: the origin is the four at
    ``shift``, read from 0); Get_accumulate's result is the window's last
    four. Each package reads the source in full before writing (numpy's
    rule), so a partial overlap gives the same bytes as a copy would."""
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        buf = AT.array(np.arange(8, dtype=np.float32))
        win = M.Win_create(buf, comm)
        M.Win_fence(0, win)
        if rank == 0:
            name, _, red = op.partition("-")
            if name == "Accumulate":
                M.Accumulate(buf[0:4], 4, 0, shift, getattr(M, red), win)
            elif name == "Get_accumulate":
                M.Get_accumulate(buf[0:4], buf[4:8], 4, 0, shift,
                                 getattr(M, red), win)
            elif name == "Put":
                M.Put(buf[0:4], 4, 0, shift, win)
            else:
                M.Get(buf[shift:shift + 4], 4, 0, 0, win)
        M.Win_fence(0, win)
        out = host(buf)
        M.Barrier(comm)
        win.free()
        return out
    return body


@pytest.mark.parametrize("shift", [0, 1, 2, 4])
@pytest.mark.parametrize("op", OVERLAP_OPS)
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_overlapping_origin_parity(kind, op, shift):
    before = counts["chained_folds"]
    assert_parity(p_overlapping_origin, kind, 2, op=op, shift=shift)
    assert counts["chained_folds"] == before


def p_cell_window_origin_views_its_cell(M, AT):
    """A DeviceBuffer window whose origins view the cell's own tensor (a
    raw tensor in the port, an array slice in the JAX package): Accumulate
    SUM at displacement 2, Put at 3 and Get_accumulate MAX at 1 into a
    second cell, one fence epoch each."""
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        buf = AT.array(np.arange(8, dtype=np.float32))
        got = AT.zeros(4, dtype=np.float32)
        win = M.Win_create(buf, comm)
        M.Win_fence(0, win)
        if rank == 0:
            M.Accumulate(buf.value[0:4], 4, 0, 2, M.SUM, win)
        M.Win_fence(0, win)
        if rank == 0:
            M.Put(buf.value[1:5], 4, 0, 3, win)
        M.Win_fence(0, win)
        if rank == 0:
            M.Get_accumulate(buf.value[0:4], got, 4, 0, 1, M.MAX, win)
        M.Win_fence(0, win)
        out = host(buf), host(got)
        M.Barrier(comm)
        win.free()
        return out
    return body


def test_cell_window_origin_views_its_cell_parity():
    assert_parity(p_cell_window_origin_views_its_cell, "devicebuffer", 2)


# ---------------------------------------------------------------------------
# Get_address
# ---------------------------------------------------------------------------

def test_get_address_on_tensors_cells_and_arrays():
    t = torch.arange(6, dtype=torch.float32)
    assert MPI.Get_address(t) == t.data_ptr()
    assert MPI.Get_address(t[2:]) == t.data_ptr() + 8
    cell = MPI.DeviceBuffer(np.arange(4.0), device="cpu")
    first = MPI.Get_address(cell)
    assert first == MPI.Get_address(cell) == cell.value.data_ptr()
    cell[0] = 5.0                       # a write rebinds the cell
    assert MPI.Get_address(cell) == cell.value.data_ptr()
    arr = np.arange(3)
    assert MPI.Get_address(arr) == JMPI.Get_address(arr)
    assert MPI.Get_address(arr[1:]) == JMPI.Get_address(arr[1:])


def test_dynamic_window_resolves_after_a_put_rebinds_the_cell():
    """A cell attached to a dynamic window keeps resolving at the address
    it had when attached, after a Put has rebound it."""
    def body():
        comm = MPI.COMM_WORLD
        rank = MPI.Comm_rank(comm)
        buf = MPI.DeviceBuffer(np.full(4, float(rank)), device="cpu")
        win = MPI.Win_create_dynamic(comm)
        MPI.Win_attach(win, buf)
        addr = MPI.Get_address(buf)
        addrs = MPI.Allgather(np.array([addr], np.int64), comm)
        MPI.Win_fence(0, win)
        if rank == 0:
            MPI.Put(np.array([7.0]), 1, 1, int(addrs[1]) + 8, win)
        MPI.Win_fence(0, win)
        moved = MPI.Get_address(buf) != addr
        got = np.zeros(2)
        if rank == 0:
            MPI.Get(got, 2, 1, int(addrs[1]) + 8, win)
        MPI.Win_fence(0, win)
        MPI.Win_detach(win, buf)
        win.free()
        return moved, buf.value.tolist(), got.tolist()

    out = MPI.testing.run_spmd(body, 2, timeout=TIMEOUT)
    assert out[1] == (True, [1.0, 7.0, 1.0, 1.0], [0.0, 0.0])
    assert out[0] == (False, [0.0] * 4, [7.0, 1.0])

