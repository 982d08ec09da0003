"""One-sided RMA across OS processes (``tpu_mpi_torch._rma_wire``), held
against the JAX package's wire engine (``tests/test_procs.py``'s RMA
cases): windows over numpy arrays, CPU tensors and
``DeviceBuffer(device="cpu")`` give the JAX package's bytes after fence,
lock, deferred and dynamic epochs, and after own-rank Puts and
accumulates whose origin overlaps the target range in part; shared
windows are host shared memory.
The harness is ``tests/test_torch_coll_algos.py``'s and
``tests/test_torch_procs.py``'s.
"""

import pytest

from test_torch_coll_algos import digests
from test_torch_procs import _finish, _launch, _launch_async, assert_parity

_runs = {}

# ---------------------------------------------------------------------------
# One-sided RMA over the wire engine
# ---------------------------------------------------------------------------

RMA = """
MPI.Init()
comm = MPI.COMM_WORLD
rank, N = MPI.Comm_rank(comm), MPI.Comm_size(comm)
for kind in KINDS:
    # fence epochs: Get from the right neighbour, Put into rank 0's slots,
    # Accumulate and a NO_OP Fetch_and_op readback
    buf = mk(np.full(N, rank, dtype=np.int64), kind)
    win = MPI.Win_create(buf, comm)
    got = mk(np.full(N, -1, dtype=np.int64), kind)
    MPI.Win_fence(0, win)
    MPI.Get(got, (rank + 1) % N, win)
    MPI.Win_fence(0, win)
    emit("fence/get", got, kind)
    MPI.Put(mk(np.array([rank], np.int64), kind), 1, 0, rank, win)
    MPI.Win_fence(0, win)
    MPI.Accumulate(mk(np.array([1], np.int64), kind), 1, 0, 0, MPI.SUM, win)
    MPI.Win_fence(0, win)
    f = mk(np.array([-1], np.int64), kind)
    MPI.Fetch_and_op(mk(np.array([0], np.int64), kind), f, 0, 0, MPI.NO_OP,
                     win)
    emit("fence/fetch", f, kind)
    MPI.Win_fence(0, win)
    emit("fence/window", buf, kind)
    win.free()

    # own-rank Put and Accumulate SUM whose origin views the window's first
    # four elements, aimed at displacement 2: the origin is read in full
    # before the target range is written, as numpy reads it
    obuf = mk(np.arange(8, dtype=np.float32) + rank, kind)
    owin = MPI.Win_create(obuf, comm)
    MPI.Win_fence(0, owin)
    MPI.Put((obuf.value if kind == "db" else obuf)[0:4], 4, rank, 2, owin)
    MPI.Win_fence(0, owin)
    emit("self/put", obuf, kind)
    MPI.Accumulate((obuf.value if kind == "db" else obuf)[0:4], 4, rank, 2,
                   MPI.SUM, owin)
    MPI.Win_fence(0, owin)
    emit("self/accumulate", obuf, kind)
    owin.free()

    # passive target: a read-modify-write counter under LOCK_EXCLUSIVE
    ctr = mk(np.zeros(1, dtype=np.int64), kind)
    win = MPI.Win_create(ctr, comm)
    MPI.Barrier(comm)
    for _ in range(3):
        MPI.Win_lock(MPI.LOCK_EXCLUSIVE, 0, 0, win)
        cur = np.zeros(1, np.int64)
        MPI.Get(cur, 1, 0, 0, win)
        MPI.Win_flush(0, win)
        MPI.Put(mk(cur + 1, kind), 1, 0, 0, win)
        MPI.Win_unlock(0, win)
    MPI.Barrier(comm)
    emit("lock/counter", ctr, kind)
    win.free()

    # deferred epochs: write-only epochs batch into one frame, reads see
    # the epoch's own Puts, overflow and flush materialize the lock
    target = mk(np.zeros(64, np.float64), kind)
    win = MPI.Win_create(target, comm)
    if rank == 0:
        MPI.Win_lock(MPI.LOCK_EXCLUSIVE, 1, 0, win)
        MPI.Put(mk(np.full(4, 5.0), kind), 4, 1, 0, win)
        MPI.Accumulate(mk(np.full(4, 2.0), kind), 4, 1, 0, MPI.SUM, win)
        MPI.Win_unlock(1, win)
        g = mk(np.zeros(4), kind)
        MPI.Win_lock(MPI.LOCK_EXCLUSIVE, 1, 0, win)
        MPI.Put(mk(np.full(4, 9.0), kind), 4, 1, 8, win)
        MPI.Get(g, 4, 1, 8, win)
        MPI.Win_unlock(1, win)
        emit("lazy/get", g, kind)
        MPI.Win_lock(MPI.LOCK_EXCLUSIVE, 1, 0, win)
        for i in range(24):
            MPI.Put(mk(np.full(1, float(i)), kind), 1, 1, 16 + i, win)
        MPI.Win_unlock(1, win)
        MPI.Win_lock(MPI.LOCK_SHARED, 1, 0, win)
        MPI.Put(mk(np.full(1, 77.0), kind), 1, 1, 63, win)
        MPI.Win_flush(1, win)
        r = mk(np.zeros(1), kind)
        MPI.Fetch_and_op(mk(np.full(1, 3.0), kind), r, 1, 63, MPI.SUM, win)
        MPI.Win_unlock(1, win)
        emit("lazy/fetch", r, kind)
    MPI.Barrier(comm)
    if rank == 1:
        emit("lazy/window", target, kind)
    MPI.Barrier(comm)
    win.free()

    # a bulk Put rides the shm lane inside one deferred epoch
    bulk = mk(np.zeros(1 << 17, np.float32), kind)
    win = MPI.Win_create(bulk, comm)
    MPI.Win_lock(MPI.LOCK_EXCLUSIVE, (rank + 1) % N, 0, win)
    MPI.Put(mk(np.arange(1 << 17, dtype=np.float32) + rank, kind), 1 << 17,
            (rank + 1) % N, 0, win)
    MPI.Win_unlock((rank + 1) % N, win)
    MPI.Barrier(comm)
    emit("bulk/window", bulk, kind)
    win.free()

    # dynamic window: rank 1 attaches and sends its address; rank 0 Puts
    dwin = MPI.Win_create_dynamic(comm)
    if rank == 1:
        arr = mk(np.zeros(4, np.float64), kind)
        MPI.Win_attach(dwin, arr)
        MPI.Send(np.array([MPI.Get_address(arr)], np.int64), 0, 9, comm)
        MPI.Win_fence(0, dwin)
        emit("dynamic", arr, kind)
        MPI.Win_detach(dwin, arr)
    elif rank == 0:
        addr = np.zeros(1, np.int64)
        MPI.Recv(addr, 1, 9, comm)
        MPI.Put(mk(np.full(4, 7.0), kind), 4, 1, int(addr[0]), dwin)
        MPI.Win_fence(0, dwin)
    else:
        MPI.Win_fence(0, dwin)
    dwin.free()

# shared windows: peers store straight into rank 0's POSIX shm slab (the
# port's slab is a CPU tensor, asked for with device="cpu")
kw = {"device": "cpu"} if TORCH else {}
swin, local = MPI.Win_allocate_shared(np.float64, N, comm, **kw)
MPI.Barrier(comm)
nbytes, disp_unit, slab = MPI.Win_shared_query(swin, 0)
assert nbytes == N * 8 and disp_unit == 8, (nbytes, disp_unit)
slab[rank] = float(rank * 10)
MPI.Barrier(comm)
if rank == 0:
    emit("shared", local, "tensor" if TORCH else "np")
MPI.Barrier(comm)
swin.free()
say(f"RMA-OK-{rank}")
MPI.Finalize()
"""


@pytest.fixture(scope="module")
def rma(tmp_path_factory):
    if "rma" not in _runs:
        tmp = str(tmp_path_factory.mktemp("rma"))
        procs = {pkg: _launch_async(tmp, pkg, RMA, 4)
                 for pkg in ("tpu_mpi", "tpu_mpi_torch")}
        _runs["rma"] = {pkg: _finish(p) for pkg, p in procs.items()}
    return _runs["rma"]


@pytest.mark.parametrize("prefix", [
    "fence/get", "fence/fetch", "fence/window", "lock/counter", "lazy/get",
    "lazy/fetch", "lazy/window", "bulk/window", "dynamic", "self/put",
    "self/accumulate"])
def test_rma_bitwise_equals_the_jax_package(rma, prefix):
    assert_parity(rma, prefix)


def test_shared_window_is_host_shared_memory(rma):
    want = [v for (r, l), v in _digests(rma["tpu_mpi"]).items()
            if l == "np:shared"]
    got = [v for (r, l), v in _digests(rma["tpu_mpi_torch"]).items()
           if l == "tensor:shared"]
    assert want and got == want


def _digests(res):
    assert res.returncode == 0, res.stderr[-4000:]
    return digests(res.stdout)


def test_shared_window_on_the_card_is_refused_across_processes(tmp_path):
    """A shared slab across processes is host memory; asking for it on the
    card fails at the call instead of handing back a CPU tensor."""
    res = _launch(tmp_path, "tpu_mpi_torch", """
        from tpu_mpi_torch.error import MPIError
        MPI.Init()
        try:
            MPI.Win_allocate_shared(np.float32, 4, MPI.COMM_WORLD)
        except MPIError as e:
            assert "device" in str(e), e
            say(f"REFUSED-{MPI.Comm_rank(MPI.COMM_WORLD)}")
        MPI.Finalize()
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "REFUSED-0" in res.stdout and "REFUSED-1" in res.stdout


def test_strict_poison_on_batched_get(tmp_path):
    """Strict mode: a Get batched into a deferred epoch poisons its origin
    until Win_unlock fills it (NaN for floats, 0xA5 bytes for integers),
    for every origin kind."""
    res = _launch(tmp_path, "tpu_mpi_torch", """
        MPI.Init()
        comm = MPI.COMM_WORLD
        rank = MPI.Comm_rank(comm)
        for kind in KINDS:
            win = MPI.Win_create(mk(np.arange(4.0) + 1, kind), comm)
            iwin = MPI.Win_create(mk(np.arange(4, dtype=np.int32), kind), comm)
            if rank == 0:
                g = mk(np.zeros(4), kind)
                ig = mk(np.zeros(4, np.int32), kind)
                MPI.Win_lock(MPI.LOCK_SHARED, 1, 0, win)
                MPI.Win_lock(MPI.LOCK_SHARED, 1, 0, iwin)
                MPI.Get(g, 4, 1, 0, win)
                MPI.Get(ig, 4, 1, 0, iwin)
                assert np.isnan(host(g, kind)).all(), host(g, kind)
                assert (host(ig, kind).view(np.uint32) == 0xA5A5A5A5).all()
                MPI.Win_unlock(1, win)
                MPI.Win_unlock(1, iwin)
                assert host(g, kind).tolist() == [1.0, 2.0, 3.0, 4.0]
                assert host(ig, kind).tolist() == [0, 1, 2, 3]
            MPI.Barrier(comm)
            win.free()
            iwin.free()
        say(f"POISON-OK-{rank}")
        MPI.Finalize()
    """, env={"TPU_MPI_STRICT": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "POISON-OK-0" in res.stdout and "POISON-OK-1" in res.stdout


