"""The two-phase rebind protocol's rank-side primitive.

A resize must not remap a lease while any rank still executes (or will
execute) an op against the OLD rank map. The controller therefore brackets
the remap between two *rebind rounds* run on the rank worker threads
themselves:

- **quiesce** — after the fair queue is paused and in-flight ops drained,
  every survivor rendezvouses once more on the (already shrunk) pool comm.
  A rank passing this barrier proves it reached the step boundary with no
  tenant closure behind it in its queue.
- **resume** — after the grow + remap, the FULL post-resize pool (the
  replacements included) rendezvouses before the fair queue restarts, so
  no replacement can receive a tenant op before it finished joining.

Each round is a REAL traced ``Barrier`` — ``analyze explore`` models it as
an ordinary rendezvous, which is what lets a recorded resize trace be
verified schedule-clean — plus a matcher-visible ``elastic`` event
declaring the participant set. The T214 check
(:mod:`tpu_mpi_torch.analyze.matcher`) flags any declared rank that appears in
the trace but never recorded the round: a rank that skipped the barrier
and can race the remap.
"""

from __future__ import annotations

from ..analyze import events as _ev


def rebind_round(comm, op: str, epoch=None, declared=None) -> None:
    """Run one rebind round (``op``: "quiesce" or "resume") on the calling
    rank thread: record the elastic event, then rendezvous with every rank
    of ``comm``. ``declared`` defaults to the comm's group; a resize
    sequence number goes in ``epoch`` so rounds of different resizes never
    alias."""
    from .. import collective
    if _ev.enabled():
        _ev.record_elastic(comm, op, epoch=epoch,
                           declared=declared if declared is not None
                           else comm.group)
    collective.Barrier(comm)
