"""The counters and the algorithm selection that the port's serve tier
and ``stats`` report, held to the JAX package's: ``tests/test_perfvars.py``,
``tests/test_tune.py``, ``tests/test_tune_online.py`` and
``tests/test_config.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name.

Three reference tests name what differs by design and are written here
for the port: the capability table (an H100 row, not TPU generations)
and the two ``profile_trace`` cases (``torch.profiler`` in place of the
JAX profiler). ``test_merged_chrome_trace`` merges the ranks' traces
through the port's ``analyze.timeline``.
"""

import threading

import pytest
import torch

import tpu_mpi_torch as MPI
from tpu_mpi_torch.testing import run_spmd

from test_torch_refport import adopt, port_module

_PORT_OWN = ("test_capability_tables", "test_profile_trace_single_starter",
             "test_profile_trace_exception_safe")
for _ref in ("test_perfvars", "test_tune", "test_tune_online", "test_config"):
    adopt(globals(), port_module(_ref),
          skip=_PORT_OWN)


def test_capability_tables():
    from tpu_mpi_torch.implementations import CAPABILITIES, capabilities
    for row in CAPABILITIES.values():
        assert {"hbm_gbps", "hbm_gib", "bf16_tflops"} <= set(row)
    assert capabilities("h100-sxm")["hbm_gbps"] == 3350.0
    assert capabilities("nonsense")["hbm_gbps"] == 3350.0   # fallback row


class _FakeProfile:
    """Stands in for ``torch.profiler.profile``: counts starts and stops."""
    starts = []
    stops = 0

    def __init__(self, activities=None):
        pass

    def __enter__(self):
        _FakeProfile.starts.append(self)
        return self

    def __exit__(self, *exc):
        _FakeProfile.stops += 1

    def export_chrome_trace(self, path):
        pass


@pytest.fixture
def fake_profiler(monkeypatch):
    _FakeProfile.starts, _FakeProfile.stops = [], 0
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile


def test_profile_trace_single_starter(fake_profiler, tmp_path):
    """Thread tier: only the designated rank starts the (process-singleton)
    profiler; the other ranks' context managers no-op."""
    actives = {}

    def body():
        comm = MPI.COMM_WORLD
        with MPI.profile_trace(str(tmp_path / "t"), rank=2) as cm:
            MPI.Barrier(comm)
            actives[comm.rank()] = cm.profile is not None

    run_spmd(body, 4)
    assert len(fake_profiler.starts) == 1 and fake_profiler.stops == 1
    assert actives == {0: False, 1: False, 2: True, 3: False}


def test_profile_trace_exception_safe(fake_profiler, tmp_path):
    """An exception inside the block still stops the profiler exactly once
    and propagates (the context manager must not swallow it)."""
    errors = []

    def standalone():
        try:
            with pytest.raises(RuntimeError, match="boom"):
                with MPI.profile_trace(str(tmp_path / "t")) as cm:
                    assert cm.profile is not None
                    raise RuntimeError("boom")
        except BaseException as e:          # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=standalone)
    t.start()
    t.join()
    assert not errors, errors
    assert len(fake_profiler.starts) == 1 and fake_profiler.stops == 1
