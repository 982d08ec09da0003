"""The shared diagnostic record every analyzer pass emits.

One code space across the three passes (docs/analysis.md):

- ``Lxxx`` — static lint (:mod:`tpu_mpi_torch.analyze.lint`)
- ``Txxx`` — cross-rank trace verifier (:mod:`tpu_mpi_torch.analyze.matcher`)
- ``Rxxx`` — RMA race detector (:mod:`tpu_mpi_torch.analyze.races`)
- ``Cxxx`` — runtime lock witness (:mod:`tpu_mpi_torch.locksmith`); the static
  concurrency lint (:mod:`tpu_mpi_torch.analyze.concurrency`) shares the
  ``Lxxx`` space (L112–L115)

Each diagnostic projects onto an MPI error class
(:data:`tpu_mpi_torch.error.DIAGNOSTIC_CODES`), so ``Error_string`` /
``MPIError.Get_error_string`` cover analyzer findings exactly like
runtime-raised errors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

# code -> one-line description of the defect class.
CODES = {
    "L100": "source file could not be parsed",
    "L101": "rank-divergent collective call sequence",
    "L102": "collective root argument differs across rank branches",
    "L103": "collective op/dtype argument differs across rank branches",
    "L104": "receive count smaller than the matching send (truncation)",
    "L105": "send with no matching receive",
    "L106": "Isend buffer mutated before its Wait",
    "L107": "blocking send/recv cycle pattern (deadlock)",
    "L108": "overlapping RMA accesses in one exposure epoch",
    "L109": "persistent-request misuse (double Start / buffer mutation "
            "between Start and Wait / Start after free)",
    "L110": "operation on a revoked or shrunk communicator",
    "L111": "serve-session misuse (cross-tenant comm / op after detach)",
    "L112": "lock-order cycle across acquisition paths (potential deadlock)",
    "L113": "blocking call while holding a dispatch/pool lock",
    "L114": "shared mutable field written on multiple threads with no "
            "common guard",
    "L115": "lock released on a different path than it was acquired "
            "(missed release on an exception edge)",
    "L116": "gradient-bucket handle misuse (Start twice without Wait / "
            "Wait on an unstarted bucket)",
    "T201": "ranks called different collectives in the same round",
    "T202": "collective signature (root/dtype/count) disagrees across ranks",
    "T203": "sent message was never received",
    "T206": "Isend buffer was modified before its Wait completed",
    "T207": "agree/shrink protocol divergence across ranks",
    "T208": "per-tenant measured books fail to partition the pool totals",
    "T210": "alternate schedule deadlocks (found by analyze.explore)",
    "T211": "alternate schedule orphans a sent message",
    "T212": "wildcard receive observes schedule-dependent values",
    "T213": "algorithm selection disagrees across ranks in a collective "
            "round",
    "T214": "a rank skipped an elastic rebind quiesce/resume barrier",
    "T215": "dispatch-lock critical sections failed to serialize "
            "(op-initiation order diverges from cross-rank collective "
            "order)",
    "C401": "blocking call while holding another witnessed lock "
            "(runtime lock witness)",
    "R301": "concurrent overlapping RMA accesses (vector-clock race)",
    "R302": "donated persistent-fold result used after a later Start "
            "invalidated it",
}

# Codes deliberately absent from CODES. T204/T205 were allotted to
# receive-side pairing checks in an earlier design; both folded into T203's
# send/recv accounting (one keyed table covers "never received" and
# "received with nobody sending"), and the numbers stay reserved so old
# suppression lists keep meaning the same thing. T209 is reserved for the
# serve dispatcher's cross-cid initiation-order invariant, which the
# explorer currently reports through T210 (a divergent initiation order IS
# an alternate-schedule deadlock).
RESERVED_CODES = ("T204", "T205", "T209")


@dataclass
class Diagnostic:
    """One analyzer finding, printable as ``file:line: CODE message``."""

    code: str
    message: str
    file: str = "<unknown>"
    line: int = 0
    rank: Optional[int] = None
    # rank-condition context (lint) or op detail (trace), human-readable.
    context: str = ""
    # related sites: (file, line, note) triples (e.g. the other racing access).
    related: Tuple[tuple, ...] = field(default=())

    @property
    def mpi_code(self) -> int:
        """The MPI error class this diagnostic projects onto."""
        from ..error import diagnostic_error_code
        return diagnostic_error_code(self.code)

    def error(self):
        """This diagnostic as a raisable :class:`tpu_mpi_torch.error.AnalyzerError`."""
        from ..error import AnalyzerError
        return AnalyzerError(str(self), diag_code=self.code)

    def __str__(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        rel = "".join(f"\n    related: {f}:{ln}: {note}"
                      for f, ln, note in self.related)
        return f"{self.file}:{self.line}: {self.code} {self.message}{ctx}{rel}"
