"""tpu_mpi_torch.analyze: communication-correctness tooling (docs/analysis.md).

Three cooperating passes over one shared event IR:

- **static lint** (:mod:`.lint`, CLI ``python -m tpu_mpi_torch.lint file.py …``):
  a CPython-``ast`` pass over SPMD programs flagging rank-divergent
  collective sequences, root/op/dtype mismatches, recv truncation, unmatched
  sends, Isend-buffer reuse before Wait, blocking cycles and static RMA
  races — no runtime needed;
- **trace verifier** (:mod:`.events` + :mod:`.matcher`): a low-overhead
  tracing hook (config knob ``trace`` / env ``TPU_MPI_TRACE``) records
  per-rank events from ``comm``/``collective``/``pointtopoint``/``onesided``
  into ring buffers; the cross-rank matcher checks collective order and
  signature agreement, pairs sends with receives, and renders the
  DeadlockError dump of per-rank pending operations + the wait-for cycle;
- **RMA race detector** (:mod:`.races`): vector-clock happens-before over
  window epochs (Win_fence / Win_lock), flagging concurrent overlapping
  Put/Put and Put/Get ranges inside one exposure epoch;
- **schedule explorer** (:mod:`.explore`, CLI ``python -m tpu_mpi_torch.analyze
  explore <trace>``): DPOR-style enumeration of the alternate schedules a
  recorded run could have taken — wildcard matchings, persistent
  Start/Wait reorderings, dispatcher interleavings — checking each for
  deadlock (T210), orphaned messages (T211) and value divergence (T212).

The lint, the lock lint and the explorer are stdlib only and read no
tensor; the runtime hooks only pay for what they call. Under
``TPU_MPI_TRACE`` the Isend check reads a tensor's bytes where they lie
(one device-to-host copy at the Isend and one at its Wait for a CUDA
tensor).
"""

from __future__ import annotations

from .diagnostics import CODES, Diagnostic

__all__ = ["CODES", "Diagnostic", "lint_paths", "lint_source",
           "lock_lint_paths", "lock_lint_source", "verify_trace",
           "detect_races", "deadlock_report", "last_trace", "timeline",
           "merge_trace", "write_chrome", "clock_offsets", "explore",
           "ExploreResult", "load_trace", "dump_trace"]


def __getattr__(name):
    # lazy re-exports: keep `import tpu_mpi_torch` from paying for the ast pass
    # and keep hot modules' `from .analyze import events` cheap.
    if name in ("lint_paths", "lint_source"):
        from . import lint as _lint
        return getattr(_lint, name)
    if name in ("lock_lint_paths", "lock_lint_source"):
        from . import concurrency as _concurrency
        return getattr(_concurrency, name)
    if name in ("verify_trace", "deadlock_report"):
        from . import matcher as _matcher
        return getattr(_matcher, name)
    if name == "detect_races":
        from .races import detect_races
        return detect_races
    if name == "last_trace":
        from .events import last_trace
        return last_trace
    if name in ("load_trace", "dump_trace"):
        from . import events as _events
        return getattr(_events, name)
    if name in ("explore", "ExploreResult"):
        # "explore" resolves to the MODULE (like .timeline): the import
        # machinery pins the submodule as the package attribute anyway, so
        # returning the function here would only hold until first import.
        import importlib
        _explore = importlib.import_module(".explore", __name__)
        return _explore if name == "explore" else getattr(_explore, name)
    if name in ("timeline", "merge_trace", "write_chrome", "clock_offsets"):
        # importlib, not `from . import timeline`: the fromlist machinery
        # resolves missing attributes through THIS __getattr__ and recurses
        import importlib
        _timeline = importlib.import_module(".timeline", __name__)
        return _timeline if name == "timeline" else getattr(_timeline, name)
    raise AttributeError(f"module 'tpu_mpi_torch.analyze' has no attribute {name!r}")
