"""Completion API of the port's first slice: Status and Start/Wait over
persistent collective requests.

Reference: MPI.jl src/pointtopoint.jl — Status (:5-79), Wait!
(:404-416). The JAX package's module of the same name also holds
Send/Recv, probes, the P2P request kinds and the rest of the completion
family (Test, Waitall, Startall, ...); those come with the point-to-point
slice of the port (ROADMAP Queue A item 6). Here the requests are the
persistent collectives of :mod:`tpu_mpi_torch.collective`
(``Allreduce_init`` and friends).
"""

from __future__ import annotations

from typing import Any

from ._runtime import ANY_SOURCE, ANY_TAG
from . import error as _ec
from .error import MPIError


class Status:
    """Completion metadata of a receive (src/pointtopoint.jl:5-79)."""

    __slots__ = ("source", "tag", "error", "count", "dtype")

    def __init__(self, source: int = ANY_SOURCE, tag: int = ANY_TAG,
                 error: int = 0, count: int = 0, dtype: Any = None):
        self.source = source
        self.tag = tag
        self.error = error
        self.count = count
        self.dtype = dtype

    def __repr__(self) -> str:
        return f"Status(source={self.source}, tag={self.tag}, count={self.count})"


STATUS_EMPTY = Status()


def Wait(req) -> Status:
    """Block until req completes (ref ``Wait!`` :404-416)."""
    return req.wait()


def Start(req):
    """Arm a persistent collective request (MPI_Start): Allreduce_init,
    Bcast_init or Barrier_init. Persistent collectives must be started in
    the same order on every rank (the MPI-4 initiation-order rule)."""
    if not hasattr(req, "start"):
        raise MPIError(code=_ec.ERR_REQUEST,
                       msg="Start requires a persistent request "
                       "(Allreduce_init/Bcast_init/Barrier_init)")
    return req.start()
