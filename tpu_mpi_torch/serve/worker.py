"""Pool worker process for the procs-backend broker (``TPU_MPI_SERVE_BACKEND=procs``).

One OS process per pool rank, the serve-tier analog of a ``tpurun-torch --procs``
rank: it joins the broker's rendezvous (``launcher.Rendezvous`` — the same
coordinator the classic launcher uses), runs ``MPI.Init`` onto the native
framed transport, then dials the broker's pool-control socket and serves
``wop`` frames serially:

    broker ──OP {wop: coll, cid, ...} + part──▶ worker (this process)
    broker ◀──RESULT {oid} + result───────────  worker

The broker sends every worker's frames under ONE dispatch lock, and this
loop executes them in arrival order, so all pool ranks initiate collectives
in the same global order — the exact invariant the thread backend gets from
its per-rank queues. Collectives themselves run on the native transport
between the worker processes; the broker never touches payload bytes beyond
forwarding the client's frame views (the zero-copy path, ``serve_frame``
pvars).

Failure semantics: workers run with the heartbeat failure detector ON
(the broker's spawn env sets ``TPU_MPI_HEARTBEAT_MS`` unless the operator
chose a value), so a SIGKILL'd sibling surfaces as a typed
``ProcFailedError`` from the in-flight collective instead of a hang; the
broker additionally detects the death via control-socket EOF.

Elastic grow on this tier spawns REAL processes: survivors ``Comm_spawn``
:func:`_pool_child_entry` (a module-level function, so it serializes by
reference), and each child Inits, merges with the parent intercomm, then
dials the broker exactly like a first-generation worker — the pool-control
address rides the inherited spawn environment.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict

import numpy as np

from .. import error as _ec
from ..error import MPIError, SessionError
from . import protocol


def _cidify(cid: Any) -> Any:
    """Canonicalize a JSON-decoded cid: the wire turns tuple cids (the
    procs tier's ``("shrink", ...)``/``("c", r, n)`` forms) into lists;
    comms and channels key on the tuple form."""
    if isinstance(cid, list):
        return tuple(_cidify(c) for c in cid)
    return cid


class _PoolWorker:
    """The per-process frame loop: comm registry + wop dispatch."""

    def __init__(self, sock, ctx, rank: int):
        from .broker import _Stager
        self.sock = sock
        self.ctx = ctx
        self.rank = rank                       # world rank
        self.comms: Dict[Any, Any] = {}        # cid -> Comm
        # parts live on this process's card unless the launcher placed
        # the rank on the CPU (the broker's device="cpu")
        self.stager = _Stager(
            "cpu" if os.environ.get("TPU_MPI_PROC_DEVICE") == "cpu"
            else ctx.device_for(rank))

    # -- comm registry -------------------------------------------------------
    def _comm(self, cid):
        comm = self.comms.get(cid)
        if comm is None:
            raise SessionError(f"pool worker {self.rank}: no comm for cid "
                               f"{cid!r} (register/warm never arrived?)")
        return comm

    def _register(self, cid, group) -> None:
        from ..comm import Comm
        group = tuple(group)
        comm = Comm(group, cid, name=f"serve-pool:{cid}")
        # eager channel registration, same reason as the thread backend:
        # check_fault scopes failures by the channel's group
        self.ctx.channel(cid, len(group), group)
        self.comms[cid] = comm

    def _rebind(self, cid, group) -> None:
        """Elastic rebind: drop the stale channel (its group spans a retired
        rank), re-register the SAME cid on the remapped group."""
        with self.ctx._channels_lock:
            self.ctx._channels.pop(cid, None)
        self._register(cid, group)
        from ..overlap import plans
        plans.invalidate(cid)

    # -- wop handlers --------------------------------------------------------
    def _wop_warm(self, meta: dict) -> tuple:
        from .. import collective
        from .broker import _device_allreduce
        self._register(_cidify(meta["cid"]), meta["group"])
        comm = self.comms[_cidify(meta["cid"])]
        collective.Barrier(comm)
        _device_allreduce(self.stager, self.rank, np.ones(8, np.float32),
                          "sum", comm, keep=True)
        return {}, []

    def _wop_coll(self, meta: dict, arrays: list) -> tuple:
        from .. import collective
        from .broker import _device_allreduce, _device_bcast
        comm = self._comm(_cidify(meta["cid"]))
        kind = meta["kind"]
        keep = bool(meta.get("ret"))
        if kind == "allreduce":
            res = _device_allreduce(self.stager, self.rank, arrays[0],
                                    meta.get("reduce", "sum"), comm, keep)
        elif kind == "bcast":
            root = int(meta.get("root", 0))
            i = int(meta["i"])
            if i == root:
                src, dtype, shape = arrays[0], arrays[0].dtype, \
                    arrays[0].shape
            else:
                d = meta["desc"]
                src, dtype, shape = None, np.dtype(d["dtype"]), d["shape"]
            res = _device_bcast(self.stager, self.rank, i, root, src, dtype,
                                shape, comm, keep)
        elif kind == "barrier":
            collective.Barrier(comm)
            res = None
        else:
            raise MPIError(f"unknown pool coll kind {kind!r}",
                           code=_ec.ERR_ARG)
        if keep and res is not None:
            return {}, [res]
        return {}, []

    def _wop_free(self, meta: dict) -> tuple:
        cid = _cidify(meta["cid"])
        from ..collective import nb_shutdown
        nb_shutdown(self.ctx, cid, self.rank)
        self.comms.pop(cid, None)
        with self.ctx._channels_lock:
            self.ctx._channels.pop(cid, None)
        from ..overlap import plans
        plans.invalidate(cid)
        return {}, []

    def _wop_revoke_ns(self, meta: dict) -> None:
        """Lease reclamation for one tenant's cid range: channels dropped,
        cids revoked so a straggler raises rather than hangs."""
        base, limit = int(meta["base"]), int(meta["limit"])
        from ..overlap import plans
        with self.ctx._channels_lock:
            stale = [k for k in self.ctx._channels
                     if isinstance(k, int) and base <= k < limit]
            for k in stale:
                del self.ctx._channels[k]
        for cid in [c for c in self.comms
                    if isinstance(c, int) and base <= c < limit]:
            del self.comms[cid]
            plans.invalidate(cid)
        self.ctx.revoked_cids.update(range(base, limit))

    def _wop_round(self, meta: dict) -> tuple:
        from ..elastic.protocol import rebind_round
        comm = self._comm(_cidify(meta["cid"]))
        rebind_round(comm, meta["op"], epoch=meta.get("epoch"),
                     declared=tuple(meta.get("declared") or comm.group))
        return {}, []

    def _wop_shrink(self, meta: dict) -> tuple:
        """Collapse the base comm to its survivors. The broker is the
        failure authority on the serve tier: it ships the declared-dead
        set explicitly, so a drain-and-retire shrink (rank alive, just
        idle) takes the same path as a SIGKILL shrink."""
        from ..comm import Comm_shrink
        for r in meta.get("dead") or ():
            self.ctx.peer_failed(int(r))
        comm = self._comm(_cidify(meta["cid"]))
        shrunk = Comm_shrink(comm)
        self.comms[shrunk.cid] = shrunk
        return {"group": list(shrunk.group), "cid": shrunk.cid}, []

    def _wop_grow(self, meta: dict) -> tuple:
        """Spawn n replacement worker PROCESSES and merge them in: the
        procs-tier realization of ElasticController.grow_base. Children
        inherit this worker's environment (spawn copies os.environ), so
        TPU_MPI_SERVE_POOL_ADDR/TOKEN reach them and they dial the broker
        themselves from :func:`_pool_child_entry`."""
        from ..comm import Comm_spawn, Intercomm_merge
        comm = self._comm(_cidify(meta["cid"]))
        inter = Comm_spawn(_pool_child_entry, None, int(meta["n"]), comm)
        merged = Intercomm_merge(inter, False)
        self.comms[merged.cid] = merged
        return {"group": list(merged.group), "cid": merged.cid}, []

    def _wop_pvars(self, meta: dict) -> tuple:
        # with the counters: this process's fold-kernel launches, so the
        # broker can tell its ops went through the kernel on the card
        from .. import perfvars
        from ..kernels import fused_reduce
        return {"snapshot": perfvars.snapshot(),
                "fold_launches": fused_reduce.launches}, []

    # -- the loop ------------------------------------------------------------
    def serve(self) -> None:
        while True:
            try:
                kind, meta, arrays = protocol.recv_frame(self.sock)
            except protocol.Disconnect:
                return                       # broker went away: exit quietly
            if kind != protocol.OP:
                continue
            wop = meta.get("wop")
            oid = meta.get("oid")
            if wop == "shutdown":
                return
            # fire-and-forget control frames (no oid, no reply): ordering
            # with later ops is the socket's FIFO
            if wop == "register":
                self._register(_cidify(meta["cid"]), meta["group"])
                continue
            if wop == "rebind":
                self._rebind(_cidify(meta["cid"]), meta["group"])
                continue
            if wop == "revoke_ns":
                self._wop_revoke_ns(meta)
                continue
            try:
                if wop == "coll":
                    rmeta, rarrays = self._wop_coll(meta, arrays)
                elif wop == "warm":
                    rmeta, rarrays = self._wop_warm(meta)
                elif wop == "free":
                    rmeta, rarrays = self._wop_free(meta)
                elif wop == "round":
                    rmeta, rarrays = self._wop_round(meta)
                elif wop == "shrink":
                    rmeta, rarrays = self._wop_shrink(meta)
                elif wop == "grow":
                    rmeta, rarrays = self._wop_grow(meta)
                elif wop == "pvars":
                    rmeta, rarrays = self._wop_pvars(meta)
                elif wop == "ping":
                    rmeta, rarrays = {}, []
                else:
                    raise MPIError(f"unknown pool wop {wop!r}",
                                   code=_ec.ERR_ARG)
            except BaseException as e:       # noqa: BLE001 - typed to broker
                em = protocol.error_meta(e)
                em["oid"] = oid
                try:
                    protocol.send_frame(self.sock, protocol.ERROR, em)
                except protocol.Disconnect:
                    return
                continue
            rmeta["oid"] = oid
            try:
                protocol.send_frame(self.sock, protocol.RESULT, rmeta,
                                    rarrays)
            except protocol.Disconnect:
                return


def _attach_to_broker(base_comm=None) -> _PoolWorker:
    """HELLO onto the broker's pool-control socket and build the loop
    state. ``base_comm`` (elastic children only) pre-seeds the registry
    with the merged pool-wide comm, whose cid the broker adopted from the
    survivors' grow replies."""
    from .._runtime import require_env
    ctx, rank = require_env()
    addr = os.environ["TPU_MPI_SERVE_POOL_ADDR"]
    sock = protocol.connect(addr)
    protocol.send_frame(sock, protocol.HELLO, {
        "role": "worker", "rank": rank, "pid": os.getpid(),
        "token": os.environ.get("TPU_MPI_SERVE_POOL_TOKEN", "")})
    w = _PoolWorker(sock, ctx, rank)
    if base_comm is not None:
        w.comms[base_comm.cid] = base_comm
    return w


def _pool_child_entry() -> None:
    """Comm_spawn entry for elastic growth (module-level: serializes by
    reference). Mirrors the thread backend's child_entry: Init, merge with
    the parent intercomm (high side — survivors keep their comm-relative
    ranks), then enter the ordinary worker loop."""
    from .. import environment
    from ..comm import Comm_get_parent, Intercomm_merge
    environment.Init()
    merged = Intercomm_merge(Comm_get_parent(), True)
    _attach_to_broker(merged).serve()


def main() -> int:
    """``python -m tpu_mpi_torch.serve.worker``: first-generation pool worker,
    launched by the broker with the rendezvous triple + pool-control env."""
    from .. import environment
    environment.Init()
    worker = _attach_to_broker()
    worker.serve()
    try:
        environment.Finalize()               # clean "bye", not a failure
    except BaseException:                    # noqa: BLE001 - exiting anyway
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
