"""Plan registrations of persistent collectives die with their run.

``overlap.registry`` holds the registered buffers of every armed
persistent plan (``Allreduce_init``, and with it every ``DDPTrainer``
bucket). Every run's ``COMM_WORLD`` has cid 0 and is never freed, so the
registry keys registrations by run and cid: ``Comm.free`` releases one
communicator's, and ``spmd_run`` releases all of its run's when it returns.
The JAX package keys them by cid alone and keeps them (ROADMAP Queue C).
"""

import threading

import numpy as np
import torch

import tpu_mpi_torch as MPI
from tpu_mpi_torch import overlap
from tpu_mpi_torch.train import DDPTrainer

NRANKS = 4
TIMEOUT = 120


def _registrations() -> int:
    return overlap.registry.stats()["registrations"]


def _spec():
    """Four float64 parameters of 1 KiB: four buckets of 1 KiB."""
    rng = np.random.default_rng(3)
    return {f"p{i}": rng.standard_normal(128) for i in range(4)}


def test_ddp_runs_leave_no_registration():
    def body():
        comm = MPI.COMM_WORLD
        tr = DDPTrainer(_spec(), comm, bucket_bytes=1024, device="cpu")
        assert len(tr.bucketer.buckets) == 4
        for step in range(2):
            rng = np.random.default_rng(10 * step + comm.rank())
            tr.step((name, torch.from_numpy(rng.standard_normal(128)))
                    for name in reversed(list(_spec())))
        MPI.Barrier(comm)
        armed = _registrations()
        MPI.Barrier(comm)
        return armed

    assert _registrations() == 0
    for _ in range(2):
        armed = MPI.testing.run_spmd(body, NRANKS, timeout=TIMEOUT)
        assert armed == [4 * NRANKS] * NRANKS     # a bucket a rank, live
        assert _registrations() == 0


def test_live_communicator_keeps_its_plan_until_free():
    def body():
        world = MPI.COMM_WORLD
        dup = MPI.Comm_dup(world)
        x = MPI.DeviceBuffer(np.full(8, float(world.rank())), device="cpu")
        y = MPI.DeviceBuffer(np.zeros(8), device="cpu")
        req = MPI.Allreduce_init(x, y, MPI.SUM, dup)
        counts = []
        for _ in range(2):
            MPI.Start(req)
            MPI.Wait(req)
            MPI.Barrier(world)
            counts.append(_registrations())      # still registered
            MPI.Barrier(world)
        assert torch.equal(y.value, torch.full((8,), 6.0, dtype=torch.float64))
        dup.free()
        MPI.Barrier(world)
        counts.append(_registrations())          # released by Comm.free
        MPI.Barrier(world)
        return counts

    assert _registrations() == 0
    counts = MPI.testing.run_spmd(body, NRANKS, timeout=TIMEOUT)
    assert counts == [[NRANKS, NRANKS, 0]] * NRANKS
    assert _registrations() == 0


def test_unfreed_communicator_is_released_with_its_run():
    def body():
        dup = MPI.Comm_dup(MPI.COMM_WORLD)
        x = MPI.DeviceBuffer(np.ones(8), device="cpu")
        y = MPI.DeviceBuffer(np.zeros(8), device="cpu")
        req = MPI.Allreduce_init(x, y, MPI.SUM, dup)
        MPI.Start(req)
        MPI.Wait(req)
        MPI.Barrier(MPI.COMM_WORLD)
        return _registrations()

    assert MPI.testing.run_spmd(body, NRANKS, timeout=TIMEOUT) == [NRANKS] * NRANKS
    assert _registrations() == 0


def test_a_run_releases_only_its_own_plans():
    """Two runs at once, each with its own COMM_WORLD of cid 0: the one
    that ends first leaves the other's registrations in place."""
    armed, other_done, out = threading.Event(), threading.Event(), {}

    def arm():
        x = MPI.DeviceBuffer(np.ones(8), device="cpu")
        y = MPI.DeviceBuffer(np.zeros(8), device="cpu")
        req = MPI.Allreduce_init(x, y, MPI.SUM, MPI.COMM_WORLD)
        MPI.Start(req)
        MPI.Wait(req)
        MPI.Barrier(MPI.COMM_WORLD)
        return req

    def waiting_body():
        req = arm()
        if MPI.Comm_rank(MPI.COMM_WORLD) == 0:
            armed.set()
            assert other_done.wait(TIMEOUT)
        MPI.Barrier(MPI.COMM_WORLD)
        left = _registrations()
        MPI.Barrier(MPI.COMM_WORLD)
        return left, req.registration is not None and not req.registration.released

    def short_body():
        arm()

    waiting = threading.Thread(target=lambda: out.setdefault(
        "waiting", MPI.testing.run_spmd(waiting_body, NRANKS, timeout=TIMEOUT)))
    waiting.start()
    try:
        assert armed.wait(TIMEOUT)
        MPI.testing.run_spmd(short_body, NRANKS, timeout=TIMEOUT)
    finally:
        other_done.set()
        waiting.join(TIMEOUT)
    assert not waiting.is_alive()
    assert out["waiting"] == [(NRANKS, True)] * NRANKS
    assert _registrations() == 0
