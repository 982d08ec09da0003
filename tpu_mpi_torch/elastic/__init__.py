"""Elastic capacity for the serve tier (docs/fault-tolerance.md).

Three pieces, layered on the ULFM surface and the broker's warm
pool:

- **GROW** — the ``Comm_spawn``-shaped re-expansion after a
  ``Comm_shrink``: survivors spawn replacement rank threads, both sides
  ``Intercomm_merge`` into a new pool-wide communicator (survivors low,
  replacements high, so comm-relative ranks are preserved), the joiners
  adopt the shrunk world's agreement-epoch space, and tenant leases are
  rebound onto the replacements with the two-phase rebind protocol
  (:mod:`tpu_mpi_torch.elastic.protocol`) — no dropped or duplicated ops.
- **autoscaler** (:class:`ElasticController`) — a broker-side loop
  consuming fair-queue depth, busy-rejection backlog, infer SLO hit rate,
  and the failure detector; hysteresis and cooldown knobs are the
  ``TPU_MPI_ELASTIC_*`` family (docs/configuration.md).
- **degraded-pool serving** — between a failure and its restore resize the
  broker keeps surviving ranks streaming; ops that span the dead rank get
  the typed retriable :class:`~tpu_mpi_torch.error.PoolDegradedError`, and STATS
  re-advertises the reduced headroom.

:mod:`tpu_mpi_torch.elastic.sidecar` provides the kill-able per-rank stand-in
processes that chaos tooling (benchmarks/elastic_chaos.py, the CI
``elastic`` job) SIGKILLs to exercise the whole loop.
"""

from .controller import ElasticController
from .protocol import rebind_round

__all__ = ["ElasticController", "rebind_round"]
