"""tpu_mpi_torch.analyze: communication-correctness tooling — the part the
port runs so far.

The event IR (:mod:`.events`: the per-rank tracing hook that ``comm``,
``collective``, ``pointtopoint`` and ``onesided`` record into when
``TPU_MPI_TRACE`` is on), its diagnostic codes (:mod:`.diagnostics`), the
DeadlockError dump of per-rank pending operations
(:func:`.matcher.deadlock_report`), and the RMA race detector
(:mod:`.races`): vector-clock happens-before over window epochs
(Win_fence / Win_lock), flagging concurrent overlapping Put/Put and
Put/Get ranges inside one exposure epoch (R301) and reads of a persistent
fold's result after the Start that reuses its slot (R302). The static
lint, the cross-rank trace verifier, the schedule explorer and the
timeline renderer of the JAX package's ``analyze`` come with the analysis
slice of the port (ROADMAP Queue A item 11).
"""

from __future__ import annotations

from .diagnostics import CODES, Diagnostic

__all__ = ["CODES", "Diagnostic", "detect_races", "last_trace"]


def __getattr__(name):
    # lazy re-exports: keep hot modules' `from .analyze import events` cheap
    if name == "detect_races":
        from .races import detect_races
        return detect_races
    if name == "last_trace":
        from .events import last_trace
        return last_trace
    raise AttributeError(
        f"module 'tpu_mpi_torch.analyze' has no attribute {name!r}")
