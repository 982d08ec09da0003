"""The schedule explorer of the port (``tpu_mpi_torch.analyze.explore``).

``tests/test_analyze_explore.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name,
running the corpus rewritten for the port (``port_corpus``); its serve
gate's broker runs on ``device="cpu"``. Beside it: every corpus file
traced through both packages explores alike (schedules, transitions,
states, deadlocks, orphaned messages, truncation, and each finding's
code and line), live and after a dump and load.
"""

import os
import runpy

import pytest

import tpu_mpi
import tpu_mpi_torch

from test_torch_refport import CORPUS, adopt, corpus_subs, port_corpus, \
    port_module

_REF = port_module("test_analyze_explore", subs=corpus_subs())
adopt(globals(), _REF)

_FILES = sorted(f for f in os.listdir(CORPUS) if f.endswith(".py"))


@pytest.fixture
def both_traced(monkeypatch):
    monkeypatch.setenv("TPU_MPI_TRACE", "1")
    monkeypatch.setenv("TPU_MPI_DEADLOCK_TIMEOUT", "2.0")
    for pkg in (tpu_mpi, tpu_mpi_torch):
        pkg.config.load(refresh=True)
    yield
    os.environ.pop("TPU_MPI_AUTO_ARM_DONATE", None)
    monkeypatch.delenv("TPU_MPI_TRACE")
    for pkg in (tpu_mpi, tpu_mpi_torch):
        pkg.config.load(refresh=True)


def _summary(res):
    return {"schedules": res.schedules, "transitions": res.transitions,
            "states": res.states, "deadlocks": res.deadlocks,
            "truncated": res.truncated, "ranks": list(res.ranks),
            "findings": sorted((d.code, os.path.basename(d.file or ""),
                                d.line) for d in res.diagnostics)}


def _explored(pkg, path, tmp, **kw):
    """Run one corpus file traced on one package; its exploration live
    and after a dump and load."""
    try:
        pkg.testing.run_spmd(lambda: runpy.run_path(path, run_name="__main__"),
                             nprocs=_REF.corpus_header(path))
    except Exception:               # noqa: BLE001 — defects are expected
        pass
    tr = pkg.analyze.last_trace()
    live = pkg.analyze.explore.explore(tr, **kw)
    dump = os.path.join(tmp, pkg.__name__ + ".trace.json")
    pkg.analyze.dump_trace(tr, dump)
    loaded = pkg.analyze.explore.explore(pkg.analyze.load_trace(dump), **kw)
    return _summary(live), _summary(loaded)


@pytest.mark.parametrize("name", _FILES)
def test_explore_equals_jax_on_corpus(both_traced, tmp_path, name):
    got = _explored(tpu_mpi_torch, os.path.join(port_corpus(), name),
                    str(tmp_path))
    want = _explored(tpu_mpi, os.path.join(CORPUS, name), str(tmp_path))
    assert got == want


def test_orphans_and_budget_equal_jax(both_traced, tmp_path):
    """The wildcard files under a budget of one schedule: both truncate;
    the defect's deadlock and the orphan counts agree unbounded."""
    for name in ("clean_wildcard.py", "defect_wildcard_deadlock.py"):
        for kw in ({"max_schedules": 1}, {}):
            got = _explored(tpu_mpi_torch, os.path.join(port_corpus(), name),
                            str(tmp_path), **kw)
            want = _explored(tpu_mpi, os.path.join(CORPUS, name),
                             str(tmp_path), **kw)
            assert got == want
            assert got[0]["truncated"] == bool(kw)
            orphans = [f for f in got[0]["findings"] if f[0] == "T211"]
            assert len(orphans) == len(
                [f for f in want[0]["findings"] if f[0] == "T211"])


def test_rebuilt_explore_reads_the_ported_corpus():
    assert f"CORPUS = {port_corpus()!r}" in _REF._port_source
    assert _REF.aexplore is tpu_mpi_torch.analyze.explore
    assert _REF.serve is tpu_mpi_torch.serve
