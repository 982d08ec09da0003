"""tpu_mpi_torch.serve — the multi-tenant communicator service (docs/serving.md).

A :class:`Broker` (``tpurun-torch --serve``) owns a warm Init'd world and leases
slices of it to clients; :func:`attach` (or ``MPI.Init(session=...)``)
joins as a tenant in one sub-millisecond round trip. Per-tenant cid
namespaces isolate communicators, a deficit-round-robin
:class:`~tpu_mpi_torch.serve.queueing.FairQueue` shares the pool, and a
:class:`~tpu_mpi_torch.serve.ledger.Ledger` enforces byte quotas and attributes
pvar counters per tenant.
"""

from __future__ import annotations

from typing import Optional

from .broker import Broker
from .ledger import Ledger, POOL_TENANT
from .protocol import Disconnect
from .queueing import FairQueue
from .session import ClientSession, SessionComm, attach, attach_many

__all__ = ["Broker", "ClientSession", "SessionComm", "FairQueue", "Ledger",
           "POOL_TENANT", "Disconnect", "attach", "attach_many",
           "current_session"]

# The session MPI.Init(session=...) attached on this process (one per
# process, matching Init's once-per-rank contract). Finalize detaches it.
_current: Optional[ClientSession] = None


def current_session() -> Optional[ClientSession]:
    """The session attached by ``MPI.Init(session=...)``, or None."""
    return _current


def _set_current(session: Optional[ClientSession]) -> None:
    global _current
    _current = session
