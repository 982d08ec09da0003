"""``python -m tpu_mpi_torch.analyze <command> …`` — the analyzer CLI.

Commands:

- ``lint file.py dir/ …`` — static communication lint (also available as
  ``python -m tpu_mpi_torch.lint``);
- ``locks file.py dir/ …`` — static concurrency lint: builds the
  lock-acquisition graph and flags lock-order cycles (L112), blocking
  calls under a dispatch lock (L113), unguarded shared fields (L114) and
  missed releases on exception edges (L115)
  (:mod:`tpu_mpi_torch.analyze.concurrency`);
- ``explore <trace prefix or files> [--max-schedules N] [--max-states N]``
  — DPOR-style schedule-space verification over a recorded trace
  (:mod:`tpu_mpi_torch.analyze.explore`); record one with ``TPU_MPI_TRACE=1
  TPU_MPI_TRACE_DUMP=<prefix>`` and pass the prefix here;
- ``verify <trace prefix or files>`` — the cross-rank trace verifier
  (:func:`tpu_mpi_torch.analyze.matcher.verify_trace`) over dumped traces;
- ``flight <dump.json>`` — CRC-verify and render a crash flight-recorder
  dump (:mod:`tpu_mpi_torch.flight`): the timeline of spans, lifecycle notes and
  typed errors recorded in the seconds before the process died.

Every command prints diagnostics and exits 1 if any were found.
"""

from __future__ import annotations

import sys
from typing import List, Optional

_USAGE = __doc__


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "lint":
        from .lint import main as lint_main
        return lint_main(rest)
    if cmd == "locks":
        from .concurrency import main as locks_main
        return locks_main(rest)
    if cmd == "explore":
        from .explore import main as explore_main
        return explore_main(rest)
    if cmd == "verify":
        if not rest:
            print("usage: python -m tpu_mpi_torch.analyze verify <trace...>")
            return 2
        from .events import load_trace
        from .matcher import verify_trace
        tr = load_trace(rest if len(rest) > 1 else rest[0])
        diags = verify_trace(tr)
        for d in diags:
            print(d)
        if diags:
            print(f"{len(diags)} diagnostic(s)")
            return 1
        print("trace verifies clean")
        return 0
    if cmd == "flight":
        if not rest:
            print("usage: python -m tpu_mpi_torch.analyze flight <dump.json>")
            return 2
        from .. import flight
        status = 0
        for path in rest:
            try:
                payload = flight.read_dump(path)
            except (OSError, ValueError, KeyError) as e:
                print(f"{path}: {e}")
                status = 1
                continue
            print(flight.render(payload))
        return status
    print(f"unknown command {cmd!r}\n{_USAGE}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
