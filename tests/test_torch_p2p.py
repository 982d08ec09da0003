"""tpu_mpi_torch's point-to-point messaging against tpu_mpi's.

Every case is one SPMD program, written once against a package ``M`` and
an array factory ``AT``, run through ``tpu_mpi.testing.run_spmd`` and the
port's ``testing.run_spmd`` on the same seeded numpy inputs. Each run
asserts the reference test's own checks; the test then holds the port's
per-rank results to the JAX package's, bitwise (bfloat16 as raw bits).

Array kinds: ``numpy`` (host arrays on both sides), ``devicebuffer``
(the port's DeviceBuffer on the CPU against the JAX DeviceBuffer) and
``tensor`` (the port's raw CPU tensors, received in place, against numpy
on the JAX side).

Ported: tests/test_sendrecv.py, tests/test_wait.py, tests/test_threads.py
and tests/test_subarray.py. Beyond them: raw-tensor receives never alias
the sender's tensor, DeviceBuffer receives share under copy-on-write, and
a partitioned receive into a buffer it cannot fill in place raises before
any partition moves.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tpu_mpi as JMPI
import tpu_mpi.testing  # noqa: F401  (JMPI.testing.run_spmd)
from tpu_mpi.buffers import DeviceBuffer as JDeviceBuffer

import tpu_mpi_torch as MPI
from tpu_mpi_torch.buffers import is_wire_snapshot, to_numpy

TIMEOUT = 60
SEED = 6


def _tensor(a):
    return torch.from_numpy(np.array(a, copy=True))


# kind -> (JAX package's wrap, port's wrap) of a numpy array
KINDS = {
    "numpy": (lambda a: a, lambda a: a),
    "devicebuffer": (JDeviceBuffer, lambda a: MPI.DeviceBuffer(a, device="cpu")),
    "tensor": (lambda a: a, _tensor),
}


class AT:
    """The array factory a program body sees (the reference's ArrayType)."""

    def __init__(self, wrap):
        self.wrap = wrap

    def array(self, data, dtype=None):
        return self.wrap(np.array(data, dtype=dtype))

    def zeros(self, shape, dtype=np.float64):
        return self.wrap(np.zeros(shape, dtype=dtype))

    def full(self, shape, val, dtype=None):
        return self.wrap(np.full(shape, val, dtype=dtype))

    def item(self, a):
        """A numpy value as the right-hand side of an item assignment."""
        return _tensor(a) if self.wrap is _tensor else a


def host(v):
    """Any operand as a numpy array (bfloat16 as raw uint16 bits)."""
    if isinstance(v, MPI.DeviceBuffer):
        return to_numpy(v.value)
    if isinstance(v, torch.Tensor):
        return to_numpy(v)
    arr = np.array(v.value if isinstance(v, JDeviceBuffer) else v)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def status(st):
    return (st.source, st.tag, st.count)


def same(a, b) -> bool:
    """Bitwise equality of nested results (arrays compared as numpy)."""
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and a.dtype == b.dtype
                and a.tobytes() == b.tobytes())
    return a == b


def run_both(program, kind: str, nprocs: int, **kw):
    """``program(M, AT, **kw)`` returns a body; run it through both
    packages and return (JAX package's results, port's results)."""
    jwrap, twrap = KINDS[kind]
    j = JMPI.testing.run_spmd(program(JMPI, AT(jwrap), **kw), nprocs,
                              timeout=TIMEOUT)
    t = MPI.testing.run_spmd(program(MPI, AT(twrap), **kw), nprocs,
                             timeout=TIMEOUT)
    return j, t


def assert_parity(program, kind: str, nprocs: int, **kw):
    j, t = run_both(program, kind, nprocs, **kw)
    assert same(j, t), (j, t)
    return t


def _ring(M):
    comm = M.COMM_WORLD
    rank, size = M.Comm_rank(comm), M.Comm_size(comm)
    return comm, rank, size, (rank + 1) % size, (rank - 1) % size


# ---------------------------------------------------------------------------
# tests/test_sendrecv.py
# ---------------------------------------------------------------------------

def p_isend_irecv_ring(M, AT):
    def body():
        comm, rank, size, dst, src = _ring(M)
        N = 32
        send_mesg = AT.full(N, float(rank))
        recv_mesg = AT.zeros(N)
        rreq = M.Irecv(recv_mesg, src, src + 32, comm)
        sreq = M.Isend(send_mesg, dst, rank + 32, comm)
        stats = M.Waitall([sreq, rreq])
        assert isinstance(rreq, M.Request) and isinstance(sreq, M.Request)
        assert M.Get_source(stats[1]) == src
        assert M.Get_tag(stats[1]) == src + 32
        assert M.testing.aeq(recv_mesg, np.full(N, float(src)))
        done, _ = M.Testall([sreq, rreq])
        assert done
        return host(recv_mesg), status(stats[1])
    return body


def p_serialized_send_recv_chain(M, AT):
    def body():
        comm, rank, size, dst, src = _ring(M)
        payload = {"rank": rank, "data": list(range(3))}
        if rank == 0:
            M.send(payload, dst, rank + 32, comm)
            got = {"rank": src, "data": list(range(3))}
        else:
            got, _ = M.recv(src, src + 32, comm)
            if rank != size - 1:
                M.send(payload, dst, rank + 32, comm)
        assert got == {"rank": src, "data": [0, 1, 2]}
        return got
    return body


def p_typed_scalar_send_recv(M, AT):
    def body():
        comm, rank, size, dst, src = _ring(M)
        if rank == 0:
            M.Send(float(rank), dst, rank + 32, comm)
            recv_val = float(src)
        else:
            recv_val, _ = M.Recv(float, src, src + 32, comm)
            if rank != size - 1:
                M.Send(float(rank), dst, rank + 32, comm)
        assert recv_val == float(src)
        return recv_val
    return body


def p_waitsome_then_test(M, AT):
    def body():
        comm, rank, size, dst, src = _ring(M)
        recv_mesg = AT.zeros(8)
        rreq = M.Irecv(recv_mesg, src, src + 32, comm)
        sreq = M.Isend(AT.full(8, float(rank)), dst, rank + 32, comm)
        reqs = [sreq, rreq]
        inds, _ = M.Waitsome(reqs)
        assert len(inds) >= 1
        for i in inds:
            done, _ = M.Test(reqs[i])
            assert done
        M.Waitall(reqs)
        return host(recv_mesg)
    return body


def p_waitany_deactivates_requests(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        out = None
        if rank == 0:
            bufs = [AT.zeros(1, dtype=np.int64) for _ in range(2)]
            reqs = [M.Irecv(bufs[i], 1, i, comm) for i in range(2)]
            seen = set()
            for _ in range(2):
                i, _ = M.Waitany(reqs)
                seen.add(i)
            assert seen == {0, 1}
            assert M.Waitany(reqs) == (None, M.STATUS_EMPTY)
            assert M.Waitsome(reqs) == ([], [])
            found, idx, _ = M.Testany(reqs)
            assert found and idx is None
            out = sorted(int(host(b)[0]) for b in bufs)
            assert out == [10, 11]
        elif rank == 1:
            for i in range(2):
                M.Send(AT.array([10 + i]), 0, i, comm)
        M.Barrier(comm)
        return out
    return body


def p_proc_null_everywhere(M, AT):
    def body():
        comm = M.COMM_WORLD
        buf = AT.zeros(2)
        st = M.Recv(buf, M.PROC_NULL, 0, comm)
        assert st.source == M.PROC_NULL
        obj, st2 = M.recv(M.PROC_NULL, 0, comm)
        assert obj is None and st2.source == M.PROC_NULL
        flag, obj, _ = M.irecv(M.PROC_NULL, 0, comm)
        assert flag and obj is None
        assert M.Probe(M.PROC_NULL, 0, comm).source == M.PROC_NULL
        flag, _ = M.Iprobe(M.PROC_NULL, 0, comm)
        assert flag
        M.Send(buf, M.PROC_NULL, 0, comm)
        M.Wait(M.Isend(buf, M.PROC_NULL, 0, comm))
        M.Barrier(comm)
        return status(st), host(buf)
    return body


def p_cancel_sendrecv(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        rreq = M.Irecv(AT.zeros(8), rank, 12345, comm)
        M.Cancel(rreq)
        st = M.Wait(rreq)
        assert rreq.buffer is None
        M.Barrier(comm)
        return status(st)
    return body


def p_any_source_any_tag_probe(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank, size = M.Comm_rank(comm), M.Comm_size(comm)
        if rank == 0:
            got = set()
            for _ in range(size - 1):
                st = M.Probe(M.ANY_SOURCE, M.ANY_TAG, comm)
                n = M.Get_count(st, np.int64)
                buf = AT.zeros(n, dtype=np.int64)
                st2 = M.Recv(buf, st.source, st.tag, comm)
                assert st2.source == st.source
                got.add((st2.source, st2.tag, int(host(buf)[0])))
            assert got == {(r, 100 + r, r * 10) for r in range(1, size)}
            return sorted(got)
        M.Send(AT.full(rank, rank * 10, dtype=np.int64), 0, 100 + rank, comm)
        return None
    return body


def p_nonovertaking_order(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        got = []
        if rank == 1:
            for i in range(10):
                M.Send(AT.array([i]), 0, 7, comm)
        elif rank == 0:
            for i in range(10):
                buf = AT.zeros(1, dtype=np.int64)
                M.Recv(buf, 1, 7, comm)
                got.append(int(host(buf)[0]))
            assert got == list(range(10))
        M.Barrier(comm)
        return got
    return body


def p_truncation_error(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        raised = False
        if rank == 0:
            M.Send(AT.array(np.arange(8, dtype=np.float64)), 1, 3, comm)
        elif rank == 1:
            with pytest.raises(M.TruncationError):
                M.Recv(AT.zeros(4), 0, 3, comm)
            raised = True
        M.Barrier(comm)
        return raised
    return body


def p_iprobe_and_irecv_object(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        obj = None
        if rank == 0:
            flag, obj, st = M.irecv(1, 5, comm)
            while not flag:
                flag, obj, st = M.irecv(1, 5, comm)
            assert obj == "hello" and st.source == 1
        elif rank == 1:
            ok, _ = M.Iprobe(0, 99, comm)
            assert not ok
            M.send("hello", 0, 5, comm)
        M.Barrier(comm)
        return obj
    return body


def p_persistent_requests_halo_loop(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        sbuf = AT.zeros(3)
        rbuf = AT.zeros(3)
        sreq = M.Send_init(sbuf, nxt, 21, comm)
        rreq = M.Recv_init(rbuf, prv, 21, comm)
        assert not sreq.active and not rreq.active
        seen = []
        for it in range(5):
            sbuf[0] = float(rank * 100 + it)   # refresh before re-arming
            M.Startall([rreq, sreq])
            assert rreq.active
            sts = M.Waitall([sreq, rreq])
            assert len(sts) == 2
            assert host(rbuf)[0] == prv * 100 + it, (rank, it, rbuf)
            seen.append(host(rbuf))
        M.Start(rreq)
        with pytest.raises(M.MPIError):
            M.Start(rreq)
        M.Start(sreq)
        M.Waitall([sreq, rreq])
        with pytest.raises(M.MPIError):
            M.Start(M.Isend(AT.zeros(1), nxt, 22, comm))
        M.Recv(AT.zeros(1), prv, 22, comm)
        M.Barrier(comm)
        return seen
    return body


def p_sendrecv_replace(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        buf = AT.full(4, float(rank))
        st = M.Sendrecv_replace(buf, nxt, 3, prv, 3, comm)
        assert np.all(host(buf) == prv), buf
        return host(buf), status(st)
    return body


def p_isendrecv(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        out = AT.zeros(3)
        req = M.Isendrecv(AT.full(3, float(rank)), nxt, 5, out, prv, 5, comm)
        st = M.Wait(req)
        assert np.all(host(out) == prv) and st.source == prv
        buf = AT.full(2, float(rank))
        M.Wait(M.Isendrecv_replace(buf, nxt, 6, prv, 6, comm))
        assert np.all(host(buf) == prv), buf
        return host(out), host(buf)
    return body


P, L = 4, 3       # partitions, elements per partition


def p_partitioned_p2p(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        got = []
        if rank == 0:
            base = np.arange(P * L, dtype=np.float64)
            src = AT.array(base)
            sreq = M.Psend_init(src, P, 1, 9, comm)
            for rnd in range(2):
                M.Start(sreq)
                for i in (2, 0, 3, 1):       # filled and ready out of order
                    src[i * L:(i + 1) * L] = AT.item(base[i * L:(i + 1) * L] + 100 * rnd)
                    M.Pready(sreq, i)
                M.Wait(sreq)
        elif rank == 1:
            dst = AT.zeros(P * L)
            rreq = M.Precv_init(dst, P, 0, 9, comm)
            for rnd in range(2):
                expect = np.arange(P * L, dtype=np.float64) + 100 * rnd
                M.Start(rreq)
                deadline = time.monotonic() + 30
                while not M.Parrived(rreq, 2):       # an early partition
                    assert time.monotonic() < deadline
                    time.sleep(0.001)
                assert np.array_equal(host(dst)[2 * L:3 * L], expect[2 * L:3 * L])
                st = M.Wait(rreq)
                assert np.array_equal(host(dst), expect), (dst, expect)
                got.append((host(dst), status(st)))
        M.Barrier(comm)
        return got
    return body


def p_partitioned_validation(M, AT):
    def body():
        comm = M.COMM_WORLD
        buf = AT.zeros(10)
        with pytest.raises(M.MPIError) as ei:
            M.Psend_init(buf, 3, 0, 1, comm)      # 10 % 3 != 0
        assert ei.value.code == M.error.ERR_COUNT
        req = M.Psend_init(buf, 5, 0, 1, comm)
        with pytest.raises(M.MPIError) as ei2:
            M.Pready(req, 0)                       # before Start
        assert ei2.value.code == M.error.ERR_REQUEST
        return ei.value.code, ei2.value.code
    return body


def p_partitioned_isolated_from_wildcards(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        out = None
        if rank == 0:
            sreq = M.Psend_init(AT.array(np.arange(4.0)), 2, 1, 9, comm)
            M.Start(sreq)
            M.Pready_range(sreq, 0, 1)
            M.Wait(sreq)
            M.Send(AT.full(2, 77.0), 1, 9, comm)     # the normal message
        elif rank == 1:
            buf = AT.zeros(2)
            st = M.Recv(buf, 0, M.ANY_TAG, comm)   # must not take a partition
            assert np.all(host(buf) == 77.0) and st.tag == 9, buf
            dst = AT.zeros(4)
            rreq = M.Precv_init(dst, 2, 0, 9, comm)
            M.Start(rreq)
            M.Wait(rreq)
            assert np.array_equal(host(dst), np.arange(4.0)), dst
            out = (host(buf), host(dst))
        M.Barrier(comm)
        return out
    return body


def p_partitioned_count_mismatch_fails_loudly(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        if rank == 0:
            sreq = M.Psend_init(AT.array(np.arange(12.0)), 4, 1, 9, comm)
            M.Start(sreq)
            M.Pready_range(sreq, 0, 3)
            M.Wait(sreq)
        elif rank == 1:
            rreq = M.Precv_init(AT.zeros(12), 2, 0, 9, comm)    # 2 x 6
            M.Start(rreq)
            with pytest.raises((M.MPIError, M.AbortError)):
                M.Wait(rreq)
            return "raised"
        return None
    return body


def p_partitioned_cancel_then_wait(M, AT):
    def body():
        comm = M.COMM_WORLD
        st = None
        if M.Comm_rank(comm) == 0:
            rreq = M.Precv_init(AT.zeros(4), 2, M.Comm_size(comm) - 1, 9, comm)
            M.Start(rreq)
            M.Cancel(rreq)
            st = M.Wait(rreq)
            assert st is M.STATUS_EMPTY or st.count == 0
            st = status(st)
        M.Barrier(comm)
        return st
    return body


# ---------------------------------------------------------------------------
# tests/test_wait.py
# ---------------------------------------------------------------------------

def p_waitall(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        recvs = [AT.zeros((4,)) for _ in range(3)]
        reqs = [M.Irecv(recvs[i], prv, 10 + i, comm) for i in range(3)]
        reqs += [M.Isend(AT.full((4,), rank + i, dtype=np.float64), nxt, 10 + i,
                         comm) for i in range(3)]
        stats = M.Waitall(reqs)
        assert len(stats) == 6
        for i in range(3):
            assert M.testing.aeq(recvs[i], np.full(4, prv + i))
            assert stats[i].source == prv and stats[i].tag == 10 + i
        assert all(not r.active for r in reqs)
        return [host(r) for r in recvs], [status(s) for s in stats[:3]]
    return body


def p_waitany_waitsome(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        recvs = [AT.zeros((2,)) for _ in range(4)]
        rreqs = [M.Irecv(recvs[i], prv, i, comm) for i in range(4)]
        for i in range(4):
            M.Send(AT.full((2,), i, dtype=np.float64), nxt, i, comm)
        seen = set()
        while len(seen) < 4:
            idx, st = M.Waitany(rreqs)
            assert idx is not None and idx not in seen
            seen.add(idx)
            assert st.source == prv
        assert M.Waitany(rreqs)[0] is None
        recvs2 = [AT.zeros((2,)) for _ in range(3)]
        rreqs2 = [M.Irecv(recvs2[i], prv, 100 + i, comm) for i in range(3)]
        for i in range(3):
            M.Send(AT.full((2,), i, dtype=np.float64), nxt, 100 + i, comm)
        done = []
        while len(done) < 3:
            idxs, _ = M.Waitsome(rreqs2)
            assert idxs
            done.extend(idxs)
        assert sorted(done) == [0, 1, 2]
        assert M.Waitsome(rreqs2)[0] == []
        return [host(r) for r in recvs + recvs2]
    return body


def p_testall_testany_testsome(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        recv = AT.zeros((2,))
        rreq = M.Irecv(recv, prv, 7, comm)
        done, st = M.Test(rreq)
        if not done:
            assert st is None
        M.Send(AT.full((2,), rank, dtype=np.float64), nxt, 7, comm)
        while not M.Test(rreq)[0]:
            pass
        assert M.testing.aeq(recv, np.full(2, prv))
        assert M.Test(rreq)[0]
        recvs = [AT.zeros((1,)) for _ in range(2)]
        reqs = [M.Irecv(recvs[i], prv, 20 + i, comm) for i in range(2)]
        for i in range(2):
            M.Send(AT.full((1,), i, dtype=np.float64), nxt, 20 + i, comm)
        while True:
            alldone, stats = M.Testall(reqs)
            if alldone:
                break
        assert len(stats) == 2
        recvs3 = [AT.zeros((1,)) for _ in range(2)]
        reqs = [M.Irecv(recvs3[i], prv, 30 + i, comm) for i in range(2)]
        for i in range(2):
            M.Send(AT.full((1,), i, dtype=np.float64), nxt, 30 + i, comm)
        got = set()
        while len(got) < 2:
            got.update(M.Testsome(reqs)[0])
        assert got == {0, 1}
        return [host(r) for r in [recv] + recvs + recvs3]
    return body


def p_cancel_wait(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        req = M.Irecv(AT.zeros((2,)), rank, 999, comm)
        M.Cancel(req)
        st = M.Wait(req)
        assert not req.active
        M.Barrier(comm)
        return status(st)
    return body


AT_CASES = [p_isend_irecv_ring, p_waitsome_then_test, p_proc_null_everywhere,
            p_cancel_sendrecv, p_any_source_any_tag_probe,
            p_nonovertaking_order, p_truncation_error,
            p_waitany_deactivates_requests, p_persistent_requests_halo_loop,
            p_sendrecv_replace, p_isendrecv, p_partitioned_p2p,
            p_partitioned_validation, p_partitioned_isolated_from_wildcards,
            p_partitioned_count_mismatch_fails_loudly,
            p_partitioned_cancel_then_wait,
            p_waitall, p_waitany_waitsome, p_testall_testany_testsome,
            p_cancel_wait]
OBJECT_CASES = [p_serialized_send_recv_chain, p_typed_scalar_send_recv,
                p_iprobe_and_irecv_object]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("program", AT_CASES, ids=lambda p: p.__name__[2:])
def test_parity(program, kind, nprocs):
    assert_parity(program, kind, nprocs)


@pytest.mark.parametrize("program", OBJECT_CASES, ids=lambda p: p.__name__[2:])
def test_object_and_scalar_parity(program, nprocs):
    assert_parity(program, "numpy", nprocs)


# ---------------------------------------------------------------------------
# Flow control (tests/test_sendrecv.py:271,312): the blocking-send high-water
# mark admits by the payload's nbytes, which a tensor reports like an array
# ---------------------------------------------------------------------------

@pytest.fixture
def highwater(monkeypatch):
    def set_to(nbytes):
        monkeypatch.setenv("TPU_MPI_SEND_HIGHWATER_BYTES", str(nbytes))
        JMPI.config.load(refresh=True)
        MPI.config.load(refresh=True)
    yield set_to
    monkeypatch.delenv("TPU_MPI_SEND_HIGHWATER_BYTES", raising=False)
    JMPI.config.load(refresh=True)
    MPI.config.load(refresh=True)


def p_blocking_send_backpressure(M, AT, peaks):
    def body():
        comm = M.COMM_WORLD
        rank = comm.rank()
        got = []
        if rank == 0:
            for i in range(20):
                M.Send(AT.full(100, float(i)), 1, 5, comm)
        elif rank == 1:
            ctx, me = M._runtime.require_env()
            mb = ctx.mailboxes[me]
            time.sleep(0.3)          # let the sender run ahead
            peaks.append(mb.queued_bytes)
            buf = AT.zeros(100)
            for i in range(20):
                M.Recv(buf, 0, 5, comm)
                got.append(float(host(buf)[0]))
            assert got == [float(i) for i in range(20)]   # FIFO kept
        return got
    return body


@pytest.mark.parametrize("kind", list(KINDS))
def test_blocking_send_backpressure(kind, highwater):
    highwater(4 * 8 * 100)                              # 4 messages
    peaks = []
    assert_parity(p_blocking_send_backpressure, kind, 2, peaks=peaks)
    # each package's sender was capped: at most the mark plus one message
    assert len(peaks) == 2 and max(peaks) <= 4 * 8 * 100 + 800, peaks


def p_isend_never_blocks(M, AT):
    def body():
        comm = M.COMM_WORLD
        rank = comm.rank()
        peer = 1 - rank
        reqs = [M.Isend(AT.full(100, float(rank) + i), peer, i, comm)
                for i in range(4)]                      # 4 x 800 B >> 64 B
        buf = AT.zeros(100)
        got = []
        for i in range(4):
            M.Recv(buf, peer, i, comm)
            assert host(buf)[0] == peer + i
            got.append(host(buf))
        M.Waitall(reqs)
        return got
    return body


@pytest.mark.parametrize("kind", list(KINDS))
def test_isend_never_blocks_under_backpressure(kind, highwater):
    highwater(64)
    assert_parity(p_isend_never_blocks, kind, 2)


def p_sequence_check_traffic(M, AT):
    def body():
        comm = M.COMM_WORLD
        peer = 1 - comm.rank()
        for i in range(5):
            M.Send(AT.array([float(i)]), peer, i, comm)
        buf = AT.zeros(1)
        got = []
        for i in range(5):
            M.Recv(buf, peer, i, comm)
            got.append(float(host(buf)[0]))
        M.Barrier(comm)
        return got
    return body


def test_debug_sequence_flag_leaves_thread_traffic_alone(monkeypatch):
    """The positive half of test_debug_sequence_check_roundtrip: with the
    debug sequence check on, thread-tier traffic is unaffected."""
    monkeypatch.setenv("TPU_MPI_DEBUG_SEQUENCE", "1")
    JMPI.config.load(refresh=True)
    MPI.config.load(refresh=True)
    try:
        out = assert_parity(p_sequence_check_traffic, "numpy", 2)
        assert out == [[0.0, 1.0, 2.0, 3.0, 4.0]] * 2
    finally:
        monkeypatch.delenv("TPU_MPI_DEBUG_SEQUENCE")
        JMPI.config.load(refresh=True)
        MPI.config.load(refresh=True)


# ---------------------------------------------------------------------------
# tests/test_threads.py: THREAD_MULTIPLE
# ---------------------------------------------------------------------------

def p_thread_level_contract(M, AT):
    def program():
        env = M.environment
        provided = env.Init_thread(env.THREAD_MULTIPLE)
        assert env.THREAD_SINGLE <= provided <= env.THREAD_MULTIPLE
        assert env.Query_thread() == provided
        assert env.Is_thread_main()
        env.Finalize()
        return int(provided)
    return program


def p_threaded_isend_irecv_storm(M, AT):
    N = 10

    def program():
        env = M.environment
        env.Init_thread(env.THREAD_MULTIPLE)
        comm = M.COMM_WORLD
        rank, size = M.Comm_rank(comm), M.Comm_size(comm)
        dst, src = (rank + 1) % size, (rank - 1) % size
        send_arr = AT.array(np.arange(1.0, N + 1.0) + 10 * rank)
        recv_arr = AT.zeros(N)
        reqs: list = [None] * (2 * N)
        not_main = []
        rank_env = M._runtime.current_env()

        def worker(i):
            # a worker thread is not the thread that called Init, and must
            # still post sends and receives (THREAD_MULTIPLE)
            M._runtime.set_env(rank_env)
            try:
                not_main.append(env.Is_thread_main())
                reqs[N + i] = M.Irecv(recv_arr[i:i + 1], src, i, comm)
                reqs[i] = M.Isend(send_arr[i:i + 1], dst, i, comm)
            finally:
                M._runtime.set_env(None)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        M.Waitall(reqs)
        assert np.array_equal(host(recv_arr), np.arange(1.0, N + 1.0) + 10 * src)
        assert not any(not_main)
        env.Finalize()
        return host(recv_arr)
    return program


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("program", [p_thread_level_contract,
                                     p_threaded_isend_irecv_storm],
                         ids=lambda p: p.__name__[2:])
def test_threads_parity(program, kind):
    jwrap, twrap = KINDS[kind]
    j = JMPI.spmd_run(program(JMPI, AT(jwrap)), 4, timeout=TIMEOUT)
    t = MPI.spmd_run(program(MPI, AT(twrap)), 4, timeout=TIMEOUT)
    assert same(j, t), (j, t)


# ---------------------------------------------------------------------------
# tests/test_subarray.py and the view half of test_sendrecv_cart_shift:
# strided numpy views are derived datatypes; strided tensors go through
# to_wire's contiguous clone and receive in place
# ---------------------------------------------------------------------------

def p_contiguous_view(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        big = AT.array(np.arange(10, dtype=np.float64) + 100 * rank)
        recv_parent = AT.zeros(10)
        M.Sendrecv(big[2:6], nxt, 0, recv_parent[4:8], prv, 0, comm)
        assert M.testing.aeq(recv_parent[4:8], np.arange(2, 6) + 100 * prv)
        assert M.testing.aeq(recv_parent[:4], np.zeros(4))
        return host(recv_parent)
    return body


def p_strided_view(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        src = AT.array(np.arange(12, dtype=np.int64) + 100 * rank)
        dest = AT.zeros(12, dtype=np.int64)
        M.Sendrecv(src[::2], nxt, 1, dest[1::2], prv, 1, comm)
        assert M.testing.aeq(dest[1::2], np.arange(0, 12, 2) + 100 * prv)
        assert M.testing.aeq(dest[::2], np.zeros(6))
        return host(dest)
    return body


def p_2d_block_view(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        src = AT.array((np.arange(16, dtype=np.float64) + 100 * rank).reshape(4, 4))
        dest = AT.zeros((4, 4))
        M.Sendrecv(src[1:3, 1:3], nxt, 2, dest[0:2, 2:4], prv, 2, comm)
        want = (np.arange(16, dtype=np.float64) + 100 * prv).reshape(4, 4)[1:3, 1:3]
        assert M.testing.aeq(dest[0:2, 2:4], want)
        assert M.testing.aeq(dest[2:4, :], np.zeros((2, 4)))
        return host(dest)
    return body


def p_transposed_view(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        src = AT.array((np.arange(9, dtype=np.int64) + 10 * rank).reshape(3, 3))
        dest = AT.zeros((3, 3), dtype=np.int64)
        M.Sendrecv(src.T, nxt, 3, dest, prv, 3, comm)
        assert M.testing.aeq(dest, (np.arange(9, dtype=np.int64)
                                    + 10 * prv).reshape(3, 3).T)
        dest_t = AT.zeros((3, 3), dtype=np.int64)
        M.Sendrecv(src, nxt, 4, dest_t.T, prv, 4, comm)   # into a strided view
        return host(dest), host(dest_t)
    return body


def p_reversed_view(M, AT):
    def body():
        comm, rank, size, nxt, prv = _ring(M)
        rev_src = np.arange(5, dtype=np.float64) + rank
        rev_dest = np.zeros(5)
        M.Sendrecv(rev_src[::-1], nxt, 4, rev_dest[::-1], prv, 4, comm)
        assert M.testing.aeq(rev_dest, np.arange(5, dtype=np.float64) + prv)
        return rev_dest
    return body


def p_sendrecv_cart_shift(M, AT):
    def body():
        comm = M.COMM_WORLD
        comm_rank, comm_size = M.Comm_rank(comm), M.Comm_size(comm)
        comm_cart = M.Cart_create(comm, 1, [comm_size], [1], False)
        src_rank, dest_rank = M.Cart_shift(comm_cart, 0, -1)
        a = AT.array([comm_rank] * 3, dtype=np.float64)
        # the first element shifts left into the last slot, through views
        M.Sendrecv(a[0:1], dest_rank, 0, a[2:3], src_rank, 0, comm_cart)
        assert M.testing.aeq(a, [comm_rank, comm_rank, (comm_rank + 1) % comm_size])
        a2 = AT.array([comm_rank] * 3, dtype=np.float64)
        b = AT.array([-1.0, -1.0, -1.0])
        M.Sendrecv(a2[0:2], dest_rank, 1, b[0:2], src_rank, 1, comm_cart)
        assert M.testing.aeq(b, [(comm_rank + 1) % comm_size] * 2 + [-1.0])
        b2 = AT.array([-1.0, -1.0, -1.0])
        M.Sendrecv(a2, dest_rank, 2, b2, src_rank, 2, comm_cart)
        assert M.testing.aeq(b2, [(comm_rank + 1) % comm_size] * 3)
        return host(a), host(b), host(b2)
    return body


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("program", [p_contiguous_view, p_strided_view,
                                     p_2d_block_view, p_transposed_view,
                                     p_sendrecv_cart_shift],
                         ids=lambda p: p.__name__[2:])
def test_view_parity(program, kind, nprocs):
    assert_parity(program, kind, nprocs)


def test_reversed_view_parity(nprocs):
    """Negative strides: numpy views only (a tensor has none)."""
    assert_parity(p_reversed_view, "numpy", nprocs)


# ---------------------------------------------------------------------------
# The port's own contracts
# ---------------------------------------------------------------------------

def _ring_exchange(make, nprocs):
    """A ring Sendrecv of ``make(rank)`` operands; each rank returns its
    receive buffer, the sent tensor, and the data pointers of both."""
    def body():
        MPI.Init()
        comm, rank, size, nxt, prv = _ring(MPI)
        x, y = make(rank), make(-1)
        st = MPI.Sendrecv(x, nxt, 0, y, prv, 0, comm)
        xt = x.value if isinstance(x, MPI.DeviceBuffer) else x
        yt = y.value if isinstance(y, MPI.DeviceBuffer) else y
        MPI.Barrier(comm)
        out = (x, y, xt, yt, status(st))
        MPI.Finalize()
        return out
    return MPI.spmd_run(body, nprocs, timeout=TIMEOUT)


def _ptr(t):
    return t.untyped_storage().data_ptr()


def test_raw_tensor_receive_never_aliases_a_sender(nprocs):
    """After the receive, a raw tensor holds its own copy: no receive
    buffer shares storage with any rank's sent tensor, and a sender's later
    write in place is not seen."""
    rng = np.random.default_rng(SEED)
    data = [rng.standard_normal(257).astype(np.float32) for _ in range(nprocs)]
    res = _ring_exchange(lambda r: torch.from_numpy(data[r].copy()) if r >= 0
                         else torch.zeros(257), nprocs)
    sent = {_ptr(xt) for _, _, xt, _, _ in res}
    for r, (_, y, _, yt, st) in enumerate(res):
        assert _ptr(yt) not in sent
        assert np.array_equal(to_numpy(y), data[(r - 1) % nprocs])
        assert st == ((r - 1) % nprocs, 0, 257)
    for x, _, _, _, _ in res:
        x.fill_(7.0)
    for r, (_, y, _, _, _) in enumerate(res):
        assert np.array_equal(to_numpy(y), data[(r - 1) % nprocs])


def test_device_buffer_receive_shares_under_copy_on_write(nprocs):
    """A DeviceBuffer receive is zero-copy: the receiver's cell holds the
    sender's tensor; a later write through the sender's cell rebinds the
    sender only."""
    rng = np.random.default_rng(SEED)
    data = [rng.standard_normal(257).astype(np.float32) for _ in range(nprocs)]
    res = _ring_exchange(
        lambda r: MPI.DeviceBuffer(data[r] if r >= 0 else np.zeros(257, np.float32),
                                   device="cpu"), nprocs)
    for r, (_, y, _, yt, _) in enumerate(res):
        sender_tensor = res[(r - 1) % nprocs][2]
        assert yt is sender_tensor
    for x, _, _, _, _ in res:
        x[0] = 123.0
        x.fill(5.0)
    for r, (_, y, _, _, _) in enumerate(res):
        assert np.array_equal(host(y), data[(r - 1) % nprocs])


def test_snapshot_mark_saves_the_replace_copy(monkeypatch):
    """to_wire marks its private copies, and a send of one posts it as it
    is: Sendrecv_replace snapshots once per rank, not twice."""
    t = torch.arange(4.0)
    snap = MPI.buffers.to_wire(t, 4)
    assert is_wire_snapshot(snap) and not is_wire_snapshot(t)
    assert _ptr(snap) != _ptr(t)
    cell = MPI.DeviceBuffer(t, device="cpu")
    assert not is_wire_snapshot(MPI.buffers.to_wire(cell, 4))   # the cell holds it
    assert is_wire_snapshot(MPI.buffers.to_wire(np.arange(3.0), 3))

    calls = []
    real = MPI.pointtopoint.to_wire

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(MPI.pointtopoint, "to_wire", counted)

    def body():
        MPI.Init()
        comm, rank, size, nxt, prv = _ring(MPI)
        buf = torch.full((3,), float(rank))
        MPI.Sendrecv_replace(buf, nxt, 1, prv, 1, comm)
        MPI.Finalize()
        return buf.tolist()

    assert MPI.spmd_run(body, 3, timeout=TIMEOUT) == [[2.0] * 3, [0.0] * 3,
                                                      [1.0] * 3]
    assert len(calls) == 3


def _readonly():
    a = np.zeros(8)
    a.flags.writeable = False
    return a


@pytest.mark.parametrize("make", [lambda: torch.zeros(8, 2)[:, 0], _readonly],
                         ids=["strided-tensor", "read-only-numpy"])
def test_partitioned_receive_refuses_up_front(make):
    """A buffer the partitions cannot land in (a strided raw tensor, a
    read-only array) is refused by Precv_init, before any partition moves."""
    def body():
        MPI.Init()
        dst = make()
        with pytest.raises(MPI.MPIError, match="partitioned receive needs"):
            MPI.Precv_init(dst, 4, 0, 9, MPI.COMM_WORLD)
        MPI.Finalize()
        return float(dst.sum())

    assert MPI.spmd_run(body, 1, timeout=TIMEOUT) == [0.0]


def test_get_count_and_probe_read_metadata_only():
    """Probe and Get_count answer from the message's count and datatype:
    a bfloat16 tensor message of 6 elements is 3 float32 or 12 bytes."""
    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        rank = MPI.Comm_rank(comm)
        out = None
        if rank == 1:
            MPI.Send(torch.ones(6, dtype=torch.bfloat16), 0, 4, comm)
        else:
            st = MPI.Probe(1, 4, comm)
            out = (MPI.Get_count(st), MPI.Get_count(st, np.float32),
                   MPI.Get_count(st, np.uint8))
            buf = MPI.DeviceBuffer(np.zeros(6, np.uint16), dtype=torch.bfloat16,
                                   device="cpu")
            MPI.Recv(buf, 1, 4, comm)
            assert buf.value.tolist() == [1.0] * 6
        MPI.Finalize()
        return out

    assert MPI.spmd_run(body, 2, timeout=TIMEOUT)[0] == (6, 3, 12)


def test_object_message_carries_a_tensor():
    """send/recv pickle: a tensor inside an object comes back equal, on
    the device it left from."""
    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        rank = MPI.Comm_rank(comm)
        got = None
        if rank == 0:
            MPI.send({"w": torch.arange(5.0)}, 1, 2, comm)
        else:
            got, st = MPI.recv(0, 2, comm)
            assert st.source == 0
        MPI.Finalize()
        return got

    got = MPI.spmd_run(body, 2, timeout=TIMEOUT)[1]
    assert got["w"].device.type == "cpu" and got["w"].tolist() == [0, 1, 2, 3, 4]


def test_bfloat16_messages_bitwise(nprocs):
    """bfloat16 DeviceBuffers travel as their bits in both packages."""
    import ml_dtypes
    rng = np.random.default_rng(SEED)
    bits = [rng.integers(0, 1 << 16, 33, dtype=np.uint16) for _ in range(nprocs)]
    for b in bits:
        b[(b & 0x7F80) == 0x7F80] = 0        # no NaN / inf payloads

    def prog(M, AT):
        def body():
            comm, rank, size, nxt, prv = _ring(M)
            if M is MPI:
                x = MPI.DeviceBuffer(bits[rank], dtype=torch.bfloat16, device="cpu")
                y = MPI.DeviceBuffer(np.zeros(33, np.uint16), dtype=torch.bfloat16,
                                     device="cpu")
            else:
                x = JDeviceBuffer(bits[rank].view(ml_dtypes.bfloat16))
                y = JDeviceBuffer(np.zeros(33, ml_dtypes.bfloat16))
            M.Sendrecv(x, nxt, 0, y, prv, 0, comm)
            return host(y)
        return body

    j, t = run_both(prog, "numpy", nprocs)
    assert same(j, t)
    assert all(np.array_equal(t[r], bits[(r - 1) % nprocs]) for r in range(nprocs))
