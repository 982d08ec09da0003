"""The port's RMA race detector (tpu_mpi_torch.analyze.races) against
tpu_mpi's.

The 13 cases of tests/test_analyze_races.py: the unit tier builds the
same event stream with each package's ``Event``/``Tracer`` and holds the
two detectors' diagnostics equal; the integration tier runs one SPMD
program (a threading.Barrier or Event pins the schedule) through both
packages with tracing on and holds the races found equal, file and line
included. Beyond them: R302, a read of a persistent fold's result after
the Start that reuses its slot, on a hand-built stream.
"""

import threading

import numpy as np
import pytest

import tpu_mpi as JMPI
import tpu_mpi_torch as MPI
from tpu_mpi import analyze as janalyze, config as jconfig
from tpu_mpi.analyze import events as jevents, races as jraces
from tpu_mpi_torch import analyze as tanalyze, config as tconfig
from tpu_mpi_torch.analyze import events as tevents, races as traces

from test_torch_p2p import TIMEOUT

PACKAGES = ((jevents, jraces), (tevents, traces))


def _diag(d):
    return (d.code, d.message, d.file, d.line, d.rank, d.context, d.related)


# ---------------------------------------------------------------------------
# Unit tier: explicit vector clocks, no runtime involved
# ---------------------------------------------------------------------------

def _ev(ev_mod, origin, op, lo, hi, vc, t, target=1, win=7):
    return ev_mod.Event("rma", origin, op=op, win=win, peer=target, lo=lo,
                        hi=hi, vc=dict(vc), origin=origin, file=f"r{origin}.py",
                        line=10 + origin, t=float(t))


# name -> (event specs, expected R301 count); a spec is _ev's arguments
UNIT_CASES = {
    "concurrent_overlapping_puts_race": (
        [(0, "Put", 0, 4, {0: 1}, 1.0), (1, "Put", 2, 6, {1: 1}, 2.0)], 1),
    "ordered_puts_do_not_race": (
        [(0, "Put", 0, 4, {0: 1}, 1.0), (1, "Put", 2, 6, {0: 1, 1: 1}, 2.0)], 0),
    "disjoint_ranges_do_not_race": (
        [(0, "Put", 0, 4, {0: 1}, 1.0), (1, "Put", 4, 8, {1: 1}, 2.0)], 0),
    "get_get_does_not_race": (
        [(0, "Get", 0, 4, {0: 1}, 1.0), (1, "Get", 0, 4, {1: 1}, 2.0)], 0),
    "put_get_races": (
        [(0, "Put", 0, 4, {0: 1}, 1.0), (1, "Get", 0, 4, {1: 1}, 2.0)], 1),
    "accumulate_accumulate_is_ordered_by_definition": (
        [(0, "Accumulate", 0, 4, {0: 1}, 1.0),
         (1, "Accumulate", 0, 4, {1: 1}, 2.0),
         (1, "Fetch_and_op", 0, 1, {1: 2}, 3.0)], 0),
    "accumulate_put_races": (
        [(0, "Accumulate", 0, 4, {0: 1}, 1.0), (1, "Put", 0, 4, {1: 1}, 2.0)], 1),
    "same_origin_never_races_with_itself": (
        [(0, "Put", 0, 4, {0: 1}, 1.0), (0, "Put", 0, 4, {0: 2}, 2.0)], 0),
    "different_windows_do_not_race": (
        [(0, "Put", 0, 4, {0: 1}, 1.0, 1, 7), (1, "Put", 0, 4, {1: 1}, 2.0, 1, 8)], 0),
    "different_targets_do_not_race": (
        [(0, "Put", 0, 4, {0: 1}, 1.0, 0), (1, "Put", 0, 4, {1: 1}, 2.0, 1)], 0),
    "duplicate_pairs_are_deduped": (
        [(0, "Put", 0, 4, {0: 1}, 1.0), (0, "Put", 0, 4, {0: 2}, 2.0),
         (1, "Put", 0, 4, {1: 1}, 3.0), (1, "Put", 0, 4, {1: 2}, 4.0)], 1),
}


@pytest.mark.parametrize("name", list(UNIT_CASES))
def test_unit_parity(name):
    specs, want = UNIT_CASES[name]
    found = []
    for ev_mod, races in PACKAGES:
        tr = ev_mod.Tracer(2, 64)
        tr.rma_events.extend(_ev(ev_mod, *s) for s in specs)
        found.append([_diag(d) for d in races.detect_races(tr)])
    assert found[0] == found[1]
    assert len(found[1]) == want
    assert all(d[0] == "R301" and d[6] for d in found[1])


def test_race_reports_the_actual_overlap():
    tr = tevents.Tracer(2, 64)
    tr.rma_events.extend([_ev(tevents, 0, "Put", 0, 4, {0: 1}, 1.0),
                          _ev(tevents, 1, "Put", 2, 6, {1: 1}, 2.0)])
    (d,) = traces.detect_races(tr)
    assert "[2, 4)" in d.message and d.related


def test_donation_race_parity():
    """R302: a traced op reading a persistent result after the Start that
    reuses its slot; a result produced again clears the stale entry."""
    def stream(ev_mod):
        E = ev_mod.Event
        return [E("wait", 0, op="Allreduce", handle=1, round=0, bufid=11,
                  file="u.py", line=3, t=1.0),
                E("start", 0, op="Allreduce", handle=1, round=2, bufid=11,
                  file="u.py", line=4, t=2.0),
                E("coll", 0, op="Bcast", bufid=11, file="u.py", line=5, t=3.0),
                E("wait", 1, op="Allreduce", handle=1, round=0, bufid=12,
                  file="u.py", line=3, t=1.0),
                E("start", 1, op="Allreduce", handle=1, round=2, bufid=12,
                  file="u.py", line=4, t=2.0),
                E("wait", 1, op="Allreduce", handle=1, round=2, bufid=12,
                  file="u.py", line=6, t=3.0),
                E("coll", 1, op="Bcast", bufid=12, file="u.py", line=7, t=4.0)]

    found = []
    for ev_mod, races in PACKAGES:
        tr = ev_mod.Tracer(2, 64)
        for ev in stream(ev_mod):
            tr.record(ev)
        found.append([_diag(d) for d in races.detect_donation_races(tr)])
    assert found[0] == found[1]
    assert [(d[0], d[2], d[3], d[4]) for d in found[1]] == [("R302", "u.py", 5, 0)]


# ---------------------------------------------------------------------------
# Integration tier: forced interleavings through both runtimes
# ---------------------------------------------------------------------------

@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("TPU_MPI_TRACE", "1")
    jconfig.load(refresh=True)
    tconfig.load(refresh=True)
    yield
    monkeypatch.delenv("TPU_MPI_TRACE")
    jconfig.load(refresh=True)
    tconfig.load(refresh=True)


def _races_of_both(program):
    found = []
    for M, analyze in ((JMPI, janalyze), (MPI, tanalyze)):
        M.testing.run_spmd(program(M), 2, timeout=TIMEOUT)
        found.append([_diag(d) for d in analyze.detect_races(analyze.last_trace())])
    assert found[0] == found[1]
    return found[1]


def p_fence_epoch_overlap(M):
    step = threading.Barrier(2)        # pins both Puts inside one epoch

    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        win = M.Win_create(np.zeros(8), comm)
        M.Win_fence(0, win)
        if rank == 0:
            M.Put(np.ones(4), 4, 1, 0, win)
        step.wait()
        if rank == 1:
            M.Put(np.full(4, 2.0), 4, 1, 2, win)
        M.Win_fence(0, win)
        win.free()
    return body


def p_fence_separated_epochs(M):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        win = M.Win_create(np.zeros(8), comm)
        M.Win_fence(0, win)
        if rank == 0:
            M.Put(np.ones(4), 4, 1, 0, win)
        M.Win_fence(0, win)
        if rank == 1:
            M.Put(np.full(4, 2.0), 4, 1, 2, win)
        M.Win_fence(0, win)
        win.free()
    return body


def _locked_writers(M, lock):
    # rank 0 always locks first (the event forces the schedule), so the
    # detector must derive rank1-after-rank0 from the lock protocol alone
    turn = threading.Event()

    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        win = M.Win_create(np.zeros(8), comm)
        M.Win_fence(0, win)
        if rank == 0:
            M.Win_lock(getattr(M, lock), 1, 0, win)
            M.Put(np.ones(4), 4, 1, 0, win)
            M.Win_unlock(1, win)
            turn.set()
        else:
            turn.wait(timeout=30)
            M.Win_lock(getattr(M, lock), 1, 0, win)
            M.Put(np.full(4, 2.0), 4, 1, 2, win)
            M.Win_unlock(1, win)
        M.Win_fence(0, win)
        win.free()
    return body


@pytest.mark.parametrize("program, races", [
    (p_fence_epoch_overlap, 1),
    (p_fence_separated_epochs, 0),
    (lambda M: _locked_writers(M, "LOCK_EXCLUSIVE"), 0),
    (lambda M: _locked_writers(M, "LOCK_SHARED"), 1),
], ids=["fence_epoch_overlap_is_raced_exactly_once",
        "fence_separated_epochs_are_ordered",
        "exclusive_locks_order_both_interleavings",
        "shared_locks_do_not_order_writers"])
def test_integration_parity(traced, program, races):
    found = _races_of_both(program)
    assert len(found) == races and all(d[0] == "R301" for d in found)


def test_tensor_windows_race_alike(traced):
    """The port's raw-tensor windows record the same accesses as numpy
    windows in the JAX package."""
    import torch
    step = threading.Barrier(2)

    def program(M):
        def body():
            comm = M.COMM_WORLD
            rank = M.Comm_rank(comm)
            base = torch.zeros(8, dtype=torch.float64) if M is MPI else np.zeros(8)
            win = M.Win_create(base, comm)
            M.Win_fence(0, win)
            if rank == 0:
                M.Accumulate(np.ones(4), 4, 1, 0, M.SUM, win)
            step.wait()
            if rank == 1:
                M.Get(np.zeros(4), 4, 1, 3, win)
            M.Win_fence(0, win)
            win.free()
        return body

    found = _races_of_both(program)
    assert len(found) == 1 and "[3, 4)" in found[0][1]
