"""The port's persistent and nonblocking lanes against the JAX package's:
``tests/test_overlap.py`` and ``tests/test_icollective.py`` rebuilt
against the port (``test_torch_refport.port_module``) over numpy, CPU
``DeviceBuffer`` and raw CPU tensor operands, plus the lane-split stress
of DDP's pattern and the rendezvous' cross-rank round check.

The stress: 34 persistent Allreduces of unequal sizes (DDP's buckets),
Started in order and Waited in Start order, with one rank's Starts all
on the legacy lane (its ``Ibarrier`` still in flight) and the others'
on the fast-armed stack. The stack outgrows ``batch_max_ops`` and is
demoted to the nonblocking worker mid-step. Demoting one request at a
time used to submit the stack in reverse Start order (each legacy
submission first demotes the rest of the stack), so the rounds of the
split ranks paired different buckets: a fold of a 64-element bucket with
a 184-element one. Every rank must now initiate in Start order whatever
lane each Start took, and the results must be the JAX package's bits.
"""

import threading
import time

import numpy as np
import pytest
import torch

import tpu_mpi as JMPI
import tpu_mpi.testing  # noqa: F401  (JMPI.testing.run_spmd)

import tpu_mpi_torch as MPI
from tpu_mpi_torch import _runtime
from tpu_mpi_torch.error import AbortError, CollectiveMismatchError

from test_torch_refport import adopt, port_module

NRANKS = 4
TIMEOUT = 60

adopt(globals(), port_module("test_overlap"))
adopt(globals(), port_module("test_icollective"))

# DDP's pattern (train/ddp.py): 34 buckets of unequal sizes
SIZES = [64 + 8 * i for i in range(34)]


def _bucket(rank, i, n):
    rng = np.random.default_rng(1000 * i + rank)
    return rng.standard_normal(n)


def _split_lanes_body(M, wrap, go, rounds=2):
    """Every rank: Allreduce_init the 34 buckets, then per step an Ibarrier
    and the 34 Starts, Waits in Start order. Rank 0 Starts with its
    Ibarrier in flight (legacy lane); the others wait for it, drain their
    worker and Start on the fast-armed stack."""
    def body():
        comm = M.COMM_WORLD
        r = M.Comm_rank(comm)
        sends = [wrap(_bucket(r, i, n)) for i, n in enumerate(SIZES)]
        recvs = [wrap(np.zeros(n)) for n in SIZES]
        hs = [M.Allreduce_init(s, d, M.SUM, comm)
              for s, d in zip(sends, recvs)]
        out = []
        for step in range(rounds):
            if r == 0:
                ib = M.Ibarrier(comm)
                for h in hs:
                    M.Start(h)
                go[step].set()
                M.Wait(ib)
            else:
                go[step].wait(TIMEOUT)
                M.Wait(M.Ibarrier(comm))
                reg = getattr(hs[0], "registration", None)
                deadline = time.monotonic() + 10
                while reg is not None and not reg.armable() \
                        and time.monotonic() < deadline:
                    time.sleep(0.001)       # the worker's done callback
                for h in hs:
                    M.Start(h)
            for h in hs:
                M.Wait(h)
            out.append([_host(d) for d in recvs])
        return out
    return body


def _host(v):
    if isinstance(v, MPI.DeviceBuffer):
        v = v.value
    if isinstance(v, torch.Tensor):
        return v.numpy().copy()
    return np.array(v)


KINDS = {
    "numpy": lambda a: a,
    "device": lambda a: MPI.DeviceBuffer(a, device="cpu"),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_split_lanes_initiate_in_start_order_bitwise(kind):
    go = [threading.Event() for _ in range(2)]
    got = MPI.testing.run_spmd(_split_lanes_body(MPI, KINDS[kind], go),
                               NRANKS, timeout=TIMEOUT)
    want = [[sum(_bucket(r, i, n) for r in range(NRANKS))
             for i, n in enumerate(SIZES)]] * 2
    for rank_out in got:
        for step_out, step_want in zip(rank_out, want):
            for o, w in zip(step_out, step_want):
                assert o.shape == w.shape
                assert o.tobytes() == w.tobytes()


def test_reference_lane_split_fold_is_the_ports(monkeypatch):
    """The same buckets through the JAX package without the split (its
    lanes demote the same way, so only a lane-uniform run pairs): the
    port's split run gives its bits."""
    def jbody():
        comm = JMPI.COMM_WORLD
        r = JMPI.Comm_rank(comm)
        outs = []
        for i, n in enumerate(SIZES):
            outs.append(np.asarray(JMPI.Allreduce(_bucket(r, i, n),
                                                  JMPI.SUM, comm)))
        return outs
    ref = JMPI.testing.run_spmd(jbody, NRANKS, timeout=TIMEOUT)[0]
    go = [threading.Event() for _ in range(1)]
    got = MPI.testing.run_spmd(
        _split_lanes_body(MPI, KINDS["device"], go, rounds=1), NRANKS,
        timeout=TIMEOUT)
    for o, w in zip(got[1][0], ref):
        assert o.tobytes() == w.tobytes()


def test_round_stamp_names_a_persistent_mispairing():
    """Two ranks Start different persistent requests of the SAME shape as
    one round: the payloads agree, so only the round key tells; the check
    raises by name on every rank instead of folding the wrong buckets."""
    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        a = MPI.Allreduce_init(np.ones(8), np.zeros(8), MPI.SUM, comm)
        b = MPI.Allreduce_init(np.ones(8), np.zeros(8), MPI.SUM, comm)
        first, second = (b, a) if r == 1 else (a, b)
        MPI.Start(first)
        MPI.Wait(first)
        MPI.Start(second)
        MPI.Wait(second)
    with pytest.raises((CollectiveMismatchError, AbortError)) as ei:
        MPI.testing.run_spmd(body, NRANKS, timeout=TIMEOUT)
    msg = str(ei.value)
    assert "(0, 0)" in msg and "(1, 0)" in msg and "rank" in msg


def test_round_stamp_names_an_unequal_count():
    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        MPI.Allreduce(np.ones(8 if r else 9), MPI.SUM, comm)
    with pytest.raises((CollectiveMismatchError, AbortError)) as ei:
        MPI.testing.run_spmd(body, NRANKS, timeout=TIMEOUT)
    msg = str(ei.value)
    assert "(8, 'float64')" in msg and "(9, 'float64')" in msg


def test_round_stamps_are_counted_and_v_collectives_are_not():
    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        MPI.Allreduce(np.ones(4), MPI.SUM, comm)
        h = MPI.Allreduce_init(np.ones(4), np.zeros(4), MPI.SUM, comm)
        for _ in range(3):
            MPI.Start(h)
            MPI.Wait(h)
        counts = [1 + i for i in range(MPI.Comm_size(comm))]
        MPI.Allgatherv(np.ones(counts[r]), counts, comm)
    before = _runtime.stamp_stats["rounds"]
    MPI.testing.run_spmd(body, NRANKS, timeout=TIMEOUT)
    assert _runtime.stamp_stats["rounds"] - before == 4
