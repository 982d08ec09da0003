"""tpu_mpi_torch.analyze: communication-correctness tooling — the part the
port's first slice runs.

The event IR (:mod:`.events`: the per-rank tracing hook that ``comm`` and
``collective`` record into when ``TPU_MPI_TRACE`` is on), its diagnostic
codes (:mod:`.diagnostics`), and the DeadlockError dump of per-rank pending
operations (:func:`.matcher.deadlock_report`). The static lint, the
cross-rank trace verifier, the RMA race detector, the schedule explorer
and the timeline renderer of the JAX package's ``analyze`` come with the
analysis slice of the port (ROADMAP Queue A item 11).
"""

from __future__ import annotations

from .diagnostics import CODES, Diagnostic

__all__ = ["CODES", "Diagnostic"]
