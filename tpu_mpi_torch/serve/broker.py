"""The ``tpurun-torch --serve`` broker: a warm world leased to many tenants.

One broker process owns one warm :class:`~tpu_mpi_torch._runtime.SpmdContext` —
rank threads that already ran ``MPI.Init`` and a priming collective, so the
plan caches are hot — and leases slices of it to short-lived client
sessions over the framed session protocol (``serve.protocol``). The shape
(docs/serving.md):

    client ──HELLO──▶ handler thread ──▶ Ledger.charge ─▶ FairQueue
                                                             │ (DRR)
    client ◀─RESULT── handler thread ◀── PoolOp.done ◀── dispatcher
                                                             │
                                              rank worker threads (warm)

- one **handler thread** per connected client: authenticates, grants the
  lease (tenant id + rank map + cid-namespace range), then turns OP frames
  into :class:`PoolOp`\\ s and waits for their completion;
- one **dispatcher thread** pops the fair queue in deficit-round-robin
  order and fans each op out to the rank worker queues atomically, so
  every rank initiates collectives in the same global order (the same
  invariant the launcher tier gets from program order);
- N **rank worker threads**, each bound to one world rank of the warm
  context, executing closures serially. While executing for a tenant the
  thread carries the tenant in TLS (``set_current_tenant``), which routes
  ``alloc_cid`` into the tenant's namespace and arms the cross-tenant cid
  guard in ``SpmdContext.channel``.

Attach is <1 ms because nothing collective happens on the attach path: the
lease's root cid comes straight from the tenant's freshly carved namespace
(broker-side allocation, no rendezvous), and the world is already Init'd.

Device placement: the pool runs on a device (``device=``, default
``cuda``). Each rank's part of an admitted op becomes a tensor on that
device (:class:`_Stager`: one host-to-device copy, finished before the op
is), the rank threads fold it with the port's rendezvous fold (the fold
kernel on a card; its plain version on the CPU), and rank 0's result
comes back to numpy for the reply. A broker asked for ``cuda`` on a host
without one raises; it never folds on the host in its place.

Fate-sharing note: a combine-step exception would poison the whole pool
via ``ctx.fail`` (thread-tier fate sharing), so the broker validates every
op — shapes, dtypes, cid ownership, quota — at admission, before anything
touches a rank queue. A malformed op is a typed ERROR frame to one tenant,
never a pool-wide failure.
"""

from __future__ import annotations

import hmac
import itertools
import json
import os
import queue
import secrets
import socket
import subprocess
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import config
from .. import error as _ec
from .. import flight as _flight
from .. import locksmith
from .. import perfvars as _pv
from .. import tracectx as _tc
from ..analyze import events as _ev
from ..error import MPIError, PoolDegradedError, ProcFailedError, SessionError
from .._runtime import CidNamespace, SpmdContext, set_current_tenant, set_env
from . import protocol
from .ledger import CidShard, Ledger
from .queueing import FairQueue
from .worker import _cidify

_OPS = None                       # lazy operator table


def _reduce_op(name: str):
    """The pool's op for a client's reduce name: numpy's rules
    (``operators.NUMPY_RULES``), so a fold that meets a NaN or zeros of
    both signs replies the JAX broker's bits (its numpy fold), on the card
    through the fold kernel's NUMPY_* steps, on the CPU through their plain
    version."""
    global _OPS
    if _OPS is None:
        from .. import operators
        _OPS = {"sum": operators.NUMPY_SUM, "prod": operators.NUMPY_PROD,
                "min": operators.NUMPY_MIN, "max": operators.NUMPY_MAX}
    op = _OPS.get(name)
    if op is None:
        raise MPIError(f"unknown reduce op {name!r}; serve supports "
                       f"{sorted(_OPS)}", code=_ec.ERR_OP)
    return op


class _Stager:
    """Moves one pool rank's payloads between the host and the pool's
    device. Each rank keeps up to :attr:`KEEP_BYTES` of device buffers,
    one for each (dtype, shape) it staged lately, the least recently used
    dropped first: a tenant repeating an op hands the collective the same
    tensor each time, so the auto-arm lane promotes it (``chip_smoke.py``
    phase 17 times this against a tensor made for every op). A larger
    part gets a tensor made for its op. No rank folds into a tensor
    another rank reads. Every copy is blocking: a part may alias a
    front-door receive buffer that is recycled once the op is done, and a
    kept buffer is refilled by the rank's next op. Copies across the
    card's edge are counted in the ``serve_frame`` pvar block
    (``h2d``/``d2h`` copies, bytes and ns)."""

    KEEP_BYTES = 1 << 20        # per rank: the sweeps' parts are <= 16 KiB

    def __init__(self, device: Any):
        from ..buffers import resolve_device
        self.device = resolve_device(device)
        self.card = self.device.type == "cuda"
        self._kept: Dict[Any, "OrderedDict"] = {}
        self._held: Dict[Any, int] = {}

    def _buffer(self, rank: Any, dtype: torch.dtype,
                shape: tuple) -> torch.Tensor:
        nbytes = (int(np.prod(shape, dtype=np.int64))
                  * torch.empty(0, dtype=dtype).element_size())
        if nbytes > self.KEEP_BYTES:
            return torch.empty(shape, dtype=dtype, device=self.device)
        kept = self._kept.setdefault(rank, OrderedDict())
        buf = kept.pop((dtype, shape), None)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, device=self.device)
            self._held[rank] = self._held.get(rank, 0) + nbytes
        kept[(dtype, shape)] = buf
        while self._held[rank] > self.KEEP_BYTES:
            _, old = kept.popitem(last=False)
            self._held[rank] -= old.numel() * old.element_size()
        return buf

    def stage(self, rank: Any, part: np.ndarray) -> torch.Tensor:
        """``part`` copied onto the device, into a tensor of this rank's."""
        part = np.ascontiguousarray(part)
        if not part.flags.writeable:
            # a view of an immutable receive buffer (the threads
            # transport's frames): torch takes only writable arrays
            part = part.copy()
        src = torch.from_numpy(part)
        buf = self._buffer(rank, src.dtype, tuple(src.shape))
        t0 = time.perf_counter_ns()
        buf.copy_(src)
        if self.card:
            _pv.note_serve_frame(h2d=1, h2d_bytes=int(src.nbytes),
                                 h2d_ns=time.perf_counter_ns() - t0)
        return buf

    def empty(self, rank: Any, dtype: np.dtype, shape) -> torch.Tensor:
        """A receive buffer of this rank's on the device (Bcast)."""
        return self._buffer(rank, torch.from_numpy(np.empty(0, dtype)).dtype,
                            tuple(int(d) for d in shape))

    def host(self, t: Any) -> np.ndarray:
        """A result back on the host as numpy, a copy the pool keeps no
        reference to (the next op may refill a kept buffer)."""
        if not isinstance(t, torch.Tensor):
            return np.asarray(t)
        if not self.card:
            return t.detach().clone().numpy()
        t0 = time.perf_counter_ns()
        out = t.detach().cpu().numpy()
        _pv.note_serve_frame(d2h=1, d2h_bytes=int(out.nbytes),
                             d2h_ns=time.perf_counter_ns() - t0)
        return out


def _device_allreduce(stager: _Stager, rank: Any, part: np.ndarray,
                      reduce: str, comm, keep: bool):
    """One rank's share of a pool Allreduce on the device; ``keep``: this
    rank's result is the reply (rank 0), brought back to the host here,
    before the rank's next op can refill its buffers."""
    from .. import collective
    res = collective.Allreduce(stager.stage(rank, part), _reduce_op(reduce),
                               comm)
    return stager.host(res) if keep else None


def _device_bcast(stager: _Stager, rank: Any, i: int, root: int,
                  src: Optional[np.ndarray], dtype, shape, comm, keep: bool):
    """One rank's share of a pool Bcast on the device (``src`` on the
    root only)."""
    from .. import collective
    buf = (stager.stage(rank, src) if i == root
           else stager.empty(rank, dtype, shape))
    res = collective.Bcast(buf, root, comm)
    return stager.host(res) if keep else None


def _card_pool_env(environ) -> Dict[str, str]:
    """The settings a procs pool on the card pins for its workers over
    the operator's: Allreduce takes the monolithic star, whose root folds
    the workers' tensors with the fold kernel (the ring, Rabenseifner, shm
    and hierarchical tiers and the chunked star fold host copies). The
    operator's pins for other collectives stay; a pinned collective is
    never explored by the online tuner."""
    pins = [p for p in environ.get("TPU_MPI_COLL_ALGO", "").split(",")
            if p.strip() and p.partition("=")[0].strip().lower() != "allreduce"]
    return {"TPU_MPI_COLL_ALGO": ",".join(pins + ["allreduce=star"]),
            "TPU_MPI_PIPELINE_MIN_BYTES": "0"}


class PoolOp:
    """One admitted client op on its way through the fair queue to the
    rank workers. ``done`` fires once every member rank finished."""

    __slots__ = ("oid", "tenant", "kind", "cid", "parts", "reduce",
                 "root", "nbytes", "done", "results", "error",
                 "trace", "t_submit")

    def __init__(self, oid: int, tenant: str, kind: str, cid: int,
                 parts: List[np.ndarray], reduce: str, root: int):
        self.oid = oid
        self.tenant = tenant
        self.kind = kind
        self.cid = cid
        self.parts = parts
        self.reduce = reduce
        self.root = root
        self.nbytes = sum(int(p.nbytes) for p in parts)
        self.done = threading.Event()
        self.results: Optional[list] = None
        self.error: Optional[BaseException] = None
        # request tracing (tpu_mpi_torch.tracectx): the sampled request's context,
        # bound to the rank-worker TLS while the op executes so pvar
        # op-scopes emit their phase spans under it; t_submit brackets the
        # fair-queue wait span reconstructed at pop time.
        self.trace: Optional[_tc.TraceCtx] = None
        self.t_submit: Optional[float] = None


class _ThreadPool:
    """The warm world: one SpmdContext, one worker thread per rank, each
    Init'd once at broker start and reused by every tenant."""

    kind = "threads"

    def __init__(self, nranks: int, shard: Optional[CidShard] = None,
                 device: Any = "cuda"):
        self.nranks = int(nranks)              # configured (restore-target) size
        self.stager = _Stager(device)
        self.device = self.stager.device
        self.ctx = SpmdContext(self.nranks)
        # multi-broker scale-out: this broker carves tenant namespaces from
        # its own disjoint cid shard (serve.ledger.CidShard)
        self.shard = shard or CidShard()
        self.ctx._ns_next_base = self.shard.base
        # elastic membership (tpu_mpi_torch.elastic): `active` is the pool-wide
        # comm's group in merge order (survivors first, replacements after);
        # `failed` holds declared-dead world ranks; `retired` the subset
        # already shrunk out of the base comm.
        self.active: List[int] = list(range(self.nranks))
        self.failed: set = set()
        self.retired: set = set()
        self.base_comm: Any = None             # warm -> shrunk -> merged comm
        self._queues: List[queue.Queue] = [queue.Queue()
                                           for _ in range(self.nranks)]
        self._queues_lock = locksmith.make_lock("pool.queues")
        self._threads: List[threading.Thread] = []
        self._dispatch_lock = locksmith.make_lock("pool.dispatch")
        self._comms: Dict[int, Any] = {}          # cid -> Comm (shared)
        self._comms_lock = locksmith.make_lock("pool.comms")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        for r in range(self.nranks):
            t = threading.Thread(target=self._worker, args=(r,),
                                 name=f"serve-rank{r}", daemon=True)
            t.start()
            self._threads.append(t)
        self._warm()

    def _worker(self, rank: int) -> None:
        set_env((self.ctx, rank))
        from .. import environment
        environment.Init()
        self._worker_loop(rank)

    def _worker_loop(self, rank: int) -> None:
        """Consume this rank's work queue until the None sentinel. Split
        from :meth:`_worker` so a rank spawned mid-life by an elastic grow
        (already Init'd by its spawn entry) can join the same loop."""
        q = self.ensure_queue(rank)
        while True:
            item = q.get()
            if item is None:
                return
            tenant, fn = item
            set_current_tenant(tenant)
            try:
                fn(rank)
            finally:
                set_current_tenant(None)
                # drop the task closure BEFORE blocking on the next get():
                # a loop local that outlives its op pins the op's payload
                # arrays — and with recv leases those alias registered
                # buffers the front door wants to recycle (an idle pool
                # would otherwise pin its last payload forever)
                del item, fn

    # -- elastic membership --------------------------------------------------
    def healthy(self) -> List[int]:
        """World ranks currently able to serve, in comm order."""
        return [r for r in self.active if r not in self.failed]

    def dead_in(self, group) -> tuple:
        return tuple(sorted(set(group) & self.failed))

    def mark_failed(self, rank: int) -> bool:
        """Failure-detector verdict: declare a pool rank dead. Waiters on
        comms spanning it raise ProcFailedError instead of hanging; the
        rank stays in ``active`` (degraded) until a resize shrinks it out."""
        if rank in self.failed or rank not in self.active:
            return False
        self.failed.add(rank)
        self.ctx.peer_failed(rank)
        return True

    def ensure_queue(self, rank: int) -> queue.Queue:
        with self._queues_lock:
            while len(self._queues) <= rank:
                self._queues.append(queue.Queue())
            return self._queues[rank]

    def _warm(self) -> None:
        """Prime the pool before the first lease: a Barrier plus a tiny
        Allreduce on a pool-internal comm walks the whole collective path
        (channels, plan cache, jit warm-up) so the first tenant op pays
        none of it."""
        from ..comm import Comm
        cid = self.ctx.alloc_cid()            # pool allocator (no tenant TLS)
        comm = Comm(tuple(range(self.nranks)), cid, ctx=self.ctx,
                    name="serve-warm")
        with self._comms_lock:
            self._comms[cid] = comm
        self.base_comm = comm
        self._run_on_all(None, lambda rank: self._warm_body(comm, rank))

    def _warm_body(self, comm, rank: int) -> None:
        # on the device: the first tenant pays no build or launch of the
        # fold kernel
        from .. import collective
        collective.Barrier(comm)
        _device_allreduce(self.stager, rank, np.ones(8, np.float32), "sum",
                          comm, keep=True)

    def _run_on_all(self, tenant: Optional[str], fn) -> None:
        """Run ``fn(rank)`` on every healthy rank worker and wait."""
        self.run_on(self.healthy(), tenant, fn, timeout=None)

    def run_on(self, ranks, tenant: Optional[str], fn,
               timeout: Optional[float] = 120.0) -> list:
        """Run ``fn(rank)`` on the given rank workers and wait; returns the
        per-rank results in ``ranks`` order. The first exception propagates
        (after every rank finished, so no closure is left running)."""
        ranks = list(ranks)
        done = threading.Event()
        errs: list = []
        results: list = [None] * len(ranks)
        remaining = [len(ranks)]
        lock = threading.Lock()

        def make(i):
            def wrapped(rank):
                try:
                    results[i] = fn(rank)
                except BaseException as e:      # noqa: BLE001 - reported below
                    errs.append(e)
                finally:
                    with lock:
                        remaining[0] -= 1
                        if remaining[0] == 0:
                            done.set()
            return wrapped

        with self._dispatch_lock:
            for i, r in enumerate(ranks):
                self.ensure_queue(r).put((tenant, make(i)))
        if not done.wait(timeout):
            raise SessionError(f"pool closure timed out on ranks {ranks}")
        if errs:
            raise errs[0]
        return results

    def shutdown(self) -> None:
        with self._queues_lock:
            queues = list(self._queues)
        for q in queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5)

    # -- comm registry -------------------------------------------------------
    def register_comm(self, group, cid: int, tenant: str):
        from ..comm import Comm
        comm = Comm(tuple(group), cid, ctx=self.ctx,
                    name=f"serve:{tenant}")
        # eager channel registration: check_fault scopes a failure by the
        # channel's GROUP, so a comm registered while the pool is degraded
        # must not inherit the pessimistic no-group check on its first op
        set_current_tenant(tenant)
        try:
            self.ctx.channel(cid, len(comm.group), comm.group)
        finally:
            set_current_tenant(None)
        with self._comms_lock:
            self._comms[cid] = comm
        return comm

    def comm_for(self, cid: int):
        with self._comms_lock:
            return self._comms.get(cid)

    def drop_comm(self, cid: int) -> None:
        with self._comms_lock:
            self._comms.pop(cid, None)

    def rebind_comm(self, cid, group, tenant: Optional[str]):
        """Point an existing cid at a remapped group (elastic rebind): drop
        the stale channel — its group spans a retired rank and would fault-
        check forever — then register a fresh Comm and its channel. The cid
        is UNCHANGED, so the tenant's lease, ledger books, and cid-range
        ownership all survive the resize untouched."""
        from ..comm import Comm
        group = tuple(group)
        with self.ctx._channels_lock:
            self.ctx._channels.pop(cid, None)
        set_current_tenant(tenant)
        try:
            comm = Comm(group, cid, ctx=self.ctx,
                        name=f"serve:{tenant or 'pool'}")
            self.ctx.channel(cid, len(group), group)
        finally:
            set_current_tenant(None)
        with self._comms_lock:
            self._comms[cid] = comm
        from ..overlap import plans
        plans.invalidate(cid)
        return comm

    # -- elastic resize primitives (driven by tpu_mpi_torch.elastic) ----------------
    def adopt_base(self, comm) -> None:
        with self._comms_lock:
            self._comms[comm.cid] = comm
        self.base_comm = comm
        self.active = list(comm.group)

    def shrink_base(self) -> tuple:
        """Collapse the pool-wide comm to its survivors via Comm_shrink.
        EVERY member thread of the old base comm participates — including
        threads whose world rank was declared dead. That conscription is a
        thread-tier substrate honesty note: rank "death" here is a
        declaration (the sidecar process died; the rank thread shares our
        address space and cannot die independently), so the dead rank's
        thread stands in for it one last time in the ftagree rendezvous,
        exactly as ULFM's agreement excludes it from the outcome. The
        conscripted workers are then permanently retired. Returns
        ``(survivor_comm, dead_ranks)``."""
        from ..comm import Comm_shrink
        base = self.base_comm
        group = list(base.group)
        res = self.run_on(group, None, lambda rank: Comm_shrink(base))
        shrunk = next(c for r, c in zip(group, res) if r not in self.failed)
        dead = tuple(r for r in group if r in self.failed)
        for r in dead:
            self.retired.add(r)
            self.ensure_queue(r).put(None)     # retire the conscripted worker
        self.adopt_base(shrunk)
        return shrunk, dead

    def grow_base(self, n: int) -> tuple:
        """Spawn ``n`` replacement rank threads and merge them into the
        pool-wide comm (the GROW half of the elastic protocol): survivors
        collectively Comm_spawn the children, both sides Intercomm_merge,
        and merge ordering puts survivors first — so every pre-existing
        comm-relative rank is preserved. The children Init, adopt the
        merged world's epoch space (Intercomm_merge's epoch contribution),
        and enter the ordinary worker loop. Returns ``(merged_comm,
        new_world_ranks)``."""
        from ..comm import Comm_spawn, Intercomm_merge
        base = self.base_comm
        pool = self

        def child_entry():
            from .. import environment
            from ..comm import Comm_get_parent
            from ..comm import Intercomm_merge as _merge
            from .._runtime import require_env
            environment.Init()
            _, me = require_env()
            _merge(Comm_get_parent(), True)
            pool._worker_loop(me)

        def body(rank):
            inter = Comm_spawn(child_entry, None, n, base)
            return Intercomm_merge(inter, False)

        res = self.run_on(list(base.group), None, body)
        merged = res[0]
        new_ranks = tuple(r for r in merged.group if r not in base.group)
        for r in new_ranks:
            self.ensure_queue(r)
        self.adopt_base(merged)
        return merged, new_ranks

    # -- op execution --------------------------------------------------------
    def run_op(self, op: PoolOp, on_done) -> None:
        """Fan ``op`` out to every member rank's queue atomically (one
        dispatch lock → every rank sees the same initiation order) and
        return immediately; ``on_done(op)`` fires from the last rank."""
        comm = self.comm_for(op.cid)
        if comm is None:
            op.error = SessionError(f"cid {op.cid} has no live communicator")
            on_done(op)
            return
        group = comm.group
        results: list = [None] * len(group)
        remaining = [len(group)]
        lock = threading.Lock()

        def make(i):
            def run(rank):
                try:
                    if op.trace is None:
                        results[i] = self._execute(op, comm, i, rank)
                    else:
                        # bind the request's trace to this rank worker so
                        # the pvar op-scope emits its phase spans under it
                        with _tc.bind(op.trace):
                            results[i] = self._execute(op, comm, i, rank)
                except BaseException as e:      # noqa: BLE001 - sent as ERROR
                    op.error = e
                finally:
                    with lock:
                        remaining[0] -= 1
                        last = remaining[0] == 0
                    if last:
                        op.results = results
                        on_done(op)
            return run

        with self._dispatch_lock:
            for i, world_rank in enumerate(group):
                self._queues[world_rank].put((op.tenant, make(i)))

    def _execute(self, op: PoolOp, comm, i: int, rank: int):
        from .. import collective
        if op.kind == "allreduce":
            # a replicated part is staged by every rank into its own tensor
            part = op.parts[i] if len(op.parts) > 1 else op.parts[0]
            return _device_allreduce(self.stager, rank, part, op.reduce,
                                     comm, keep=i == 0)
        if op.kind == "bcast":
            src = op.parts[0]
            return _device_bcast(self.stager, rank, i, op.root, src,
                                 src.dtype, src.shape, comm, keep=i == 0)
        if op.kind == "barrier":
            collective.Barrier(comm)
            return None
        if op.kind == "dup":
            from ..comm import Comm_dup
            return Comm_dup(comm)
        if op.kind == "free":
            from ..collective import nb_shutdown
            nb_shutdown(self.ctx, op.cid, rank)
            if i == 0:
                from ..overlap import plans
                plans.invalidate(op.cid)
            return None
        raise MPIError(f"unknown serve op kind {op.kind!r}", code=_ec.ERR_ARG)

    # -- elastic rounds (driven by ElasticController._round) ------------------
    def elastic_round(self, op: str, epoch: int) -> None:
        """One rebind round on every rank of the pool-wide comm: the rank
        workers themselves rendezvous — a REAL Barrier, so explore models
        it and T214 audits the participant set."""
        from ..elastic.protocol import rebind_round
        comm = self.base_comm
        declared = tuple(comm.group)
        self.run_on(list(declared), None,
                    lambda rank: rebind_round(comm, op, epoch=epoch,
                                              declared=declared))

    # -- namespace plumbing (delegates to the warm context) -------------------
    def lease_ns(self, tenant: str, span: int):
        if self.ctx._ns_next_base + span > self.shard.limit:
            raise SessionError(
                f"broker cid shard {self.shard!r} exhausted — no room for a "
                f"{span}-cid namespace (shard the fleet wider or raise the "
                f"span)")
        return self.ctx.lease_cid_namespace(tenant, span=span)

    def release_ns(self, tenant: str) -> list:
        return self.ctx.release_cid_namespace(tenant)

    def snapshot_pvars(self) -> dict:
        from .. import perfvars
        return perfvars.snapshot()

    def info(self) -> dict:
        return {"kind": self.kind, "nranks": self.nranks,
                "active": list(self.active), "failed": sorted(self.failed),
                "capacity": len(self.healthy()),
                "comms": len(self._comms),
                "shard": [self.shard.base, self.shard.limit],
                "device": str(self.device)}


class _PoolComm:
    """Broker-side stand-in for a procs-pool communicator. The broker only
    tracks (group, cid) — the real Comm objects, channels, and payloads
    live in the worker processes; everything the Broker/elastic layers read
    off a comm (``.group``, ``.cid``) is here."""

    __slots__ = ("group", "cid", "name")

    def __init__(self, group, cid, name: str = "pool-comm"):
        self.group = tuple(group)
        self.cid = cid
        self.name = name


class _BrokerCtx:
    """Context shim for the procs backend: the broker process holds no warm
    SpmdContext, but the serve layers still need a tracer anchor
    (``events.tracer_for``) and the tenant cid-namespace books — which on
    this tier are pure broker-side bookkeeping (workers learn cids from
    explicit register/rebind frames, so no shared allocator is needed)."""

    def __init__(self, size: int, shard: CidShard):
        self.size = size
        self.cid_namespaces: Dict[str, CidNamespace] = {}
        self._ns_lock = locksmith.make_lock("brokerctx.ns")
        self._ns_next_base = shard.base
        self._ns_limit = shard.limit
        self.revoked_cids: set = set()


class _WorkerLink:
    """One pool worker process as the broker sees it: its control socket
    plus liveness state. ``closing`` marks a deliberate broker-side close
    (shutdown, retire) so the reader's EOF isn't booked as a failure."""

    __slots__ = ("rank", "sock", "pid", "closing")

    def __init__(self, rank: int, sock, pid: int):
        self.rank = rank
        self.sock = sock
        self.pid = pid
        self.closing = False


class _Pending:
    """An in-flight pool request fanned out to a set of worker ranks; fires
    (event + optional callback) once every rank replied or died."""

    __slots__ = ("oid", "want", "replies", "error", "event", "cb")

    def __init__(self, oid: int, ranks, cb=None):
        self.oid = oid
        self.want = set(ranks)
        self.replies: Dict[int, tuple] = {}
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.cb = cb


class _ProcsPool:
    """The procs-backend warm world: one OS process per pool rank on the
    native framed transport (serve/worker.py), driven over per-worker
    control sockets. The broker process never joins the world — it owns the
    rendezvous (launcher.Rendezvous, shared with classic ``tpurun-torch --procs``)
    and speaks the session frame protocol to each worker.

    Ordering invariant: every frame to every worker is sent under ONE
    dispatch lock and each worker executes its frames serially, so all
    ranks initiate collectives in the same global order — the same
    invariant the thread backend's atomic queue fan-out provides.

    Failure detection is two-plane: the broker sees a worker's control-
    socket EOF immediately (→ ``on_failure``), and the workers run the
    transport heartbeat detector so in-flight collectives spanning the dead
    rank raise typed ``ProcFailedError`` instead of hanging."""

    kind = "procs"

    #: seconds to wait for first-generation workers (cold torch import + Init)
    START_TIMEOUT = 300.0

    def __init__(self, nranks: int, shard: Optional[CidShard] = None,
                 on_failure=None, device: Any = "cuda"):
        from ..buffers import resolve_device
        self.nranks = int(nranks)
        # the workers hold their parts on this device: a card each
        # (cuda:(rank % cards)), or the CPU (the launcher's --sim placement)
        self.device = resolve_device(device)
        sim = None if self.device.type == "cuda" else 1
        self.shard = shard or CidShard()
        self.ctx = _BrokerCtx(self.nranks, self.shard)
        self.active: List[int] = list(range(self.nranks))
        self.failed: set = set()
        self.retired: set = set()
        self.base_comm: Any = None
        self.sim = sim                       # CPU-sim chips per worker; None = real
        self._on_failure = on_failure
        self._dispatch_lock = locksmith.make_lock("procs.dispatch")
        self._comms: Dict[Any, Any] = {}
        self._comms_lock = locksmith.make_lock("procs.comms")
        self._links: Dict[int, _WorkerLink] = {}
        self._links_lock = locksmith.make_lock("procs.links")
        self._link_cond = locksmith.make_condition("procs.links",
                                                   self._links_lock)
        self._pending: Dict[int, _Pending] = {}
        self._pending_lock = locksmith.make_lock("procs.pending")
        self._wire_oid = itertools.count(1)
        self._pool_cid = itertools.count(101)  # pool-internal cids < NS_FLOOR
        self._token = secrets.token_hex(16)
        self._rdv = None
        self._listener = None
        self.pool_addr: Optional[str] = None
        self._procs: List[subprocess.Popen] = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        from ..launcher import Rendezvous
        self._listener, self.pool_addr = protocol.listen(None)
        self._listener.settimeout(0.2)
        t = threading.Thread(target=self._accept_loop,
                             name="serve-pool-accept", daemon=True)
        t.start()
        self._threads.append(t)
        self._rdv = Rendezvous(self.nranks)
        extra = {"TPU_MPI_SERVE_POOL_ADDR": self.pool_addr,
                 "TPU_MPI_SERVE_POOL_TOKEN": self._token}
        # failure detection must be ON in the workers: a SIGKILL'd sibling
        # has to surface as a typed ProcFailedError from the in-flight
        # collective, not a hang (operator-set values win)
        if "TPU_MPI_HEARTBEAT_MS" not in os.environ:
            extra["TPU_MPI_HEARTBEAT_MS"] = "500"
        if "TPU_MPI_FAILURE_TIMEOUT_MS" not in os.environ:
            extra["TPU_MPI_FAILURE_TIMEOUT_MS"] = "2000"
        if self.sim is None:
            extra.update(_card_pool_env(os.environ))
        for r in range(self.nranks):
            env = self._rdv.child_env(r, sim=self.sim, extra=extra)
            # -c (not -m): serve/__init__ imports the worker module, so
            # runpy would warn about re-executing it as __main__
            self._procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import tpu_mpi_torch.serve.worker as w; raise SystemExit(w.main())"],
                env=env))
        self._wait_links(range(self.nranks), self.START_TIMEOUT)
        self._warm()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                kind, meta, _ = protocol.recv_frame(conn)
            except (protocol.Disconnect, SessionError):
                conn.close()
                continue
            if (kind != protocol.HELLO or meta.get("role") != "worker"
                    or not hmac.compare_digest(str(meta.get("token") or ""),
                                               self._token)):
                conn.close()
                continue
            link = _WorkerLink(int(meta["rank"]), conn,
                               int(meta.get("pid") or 0))
            with self._links_lock:
                self._links[link.rank] = link
                self._link_cond.notify_all()
            t = threading.Thread(target=self._reader, args=(link,),
                                 name=f"serve-pool-r{link.rank}", daemon=True)
            t.start()
            self._threads.append(t)

    def _wait_links(self, ranks, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        ranks = list(ranks)
        with self._links_lock:
            while not all(r in self._links for r in ranks):
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = [r for r in ranks if r not in self._links]
                    raise SessionError(
                        f"pool worker(s) {missing} never dialed the broker "
                        f"within {timeout:.0f}s")
                self._link_cond.wait(left)

    def _reader(self, link: _WorkerLink) -> None:
        while True:
            try:
                kind, meta, arrays = protocol.recv_frame(link.sock)
            except (protocol.Disconnect, SessionError, OSError):
                break
            oid = meta.get("oid")
            if oid is None:
                continue
            err = None
            if kind == protocol.ERROR:
                try:
                    protocol.raise_for_error(meta)
                except MPIError as e:
                    err = e
            self._resolve(oid, link.rank, meta, arrays, err)
        self._link_down(link)

    def _link_down(self, link: _WorkerLink) -> None:
        if self._stop.is_set() or link.closing:
            return
        with self._links_lock:
            if self._links.get(link.rank) is link:
                del self._links[link.rank]
        err = ProcFailedError(f"pool worker rank {link.rank} died "
                              f"(control socket EOF)")
        fire = []
        with self._pending_lock:
            for oid, p in list(self._pending.items()):
                if link.rank in p.want:
                    p.want.discard(link.rank)
                    if p.error is None:
                        p.error = err
                    if not p.want:
                        del self._pending[oid]
                        fire.append(p)
        for p in fire:
            p.event.set()
            if p.cb is not None:
                p.cb(p)
        if self._on_failure is not None:
            self._on_failure(link.rank)

    def _resolve(self, oid: int, rank: int, meta: dict, arrays: list,
                 err: Optional[BaseException]) -> None:
        with self._pending_lock:
            p = self._pending.get(oid)
            if p is None or rank not in p.want:
                return
            p.want.discard(rank)
            p.replies[rank] = (meta, arrays)
            if err is not None and p.error is None:
                p.error = err
            done = not p.want
            if done:
                del self._pending[oid]
        if done:
            p.event.set()
            if p.cb is not None:
                p.cb(p)

    # -- frame plumbing ------------------------------------------------------
    def _request(self, ranks, metas, arrays=None, cb=None) -> _Pending:
        """Fan one OP frame per rank out under the dispatch lock (the
        global-initiation-order invariant) and register the pending entry
        BEFORE sending. ``metas`` is one dict for all ranks or a per-rank
        list; a missing/dead link resolves that rank as a failure."""
        ranks = list(ranks)
        oid = next(self._wire_oid)
        p = _Pending(oid, ranks, cb)
        with self._pending_lock:
            self._pending[oid] = p
        dead = []
        with self._dispatch_lock:
            for i, r in enumerate(ranks):
                with self._links_lock:
                    link = self._links.get(r)
                if link is None:
                    dead.append(r)
                    continue
                m = dict(metas[i] if isinstance(metas, list) else metas)
                m["oid"] = oid
                try:
                    protocol.send_frame(link.sock, protocol.OP, m,
                                        arrays[i] if arrays else ())
                except protocol.Disconnect:
                    dead.append(r)
        for r in dead:
            self._resolve(oid, r, {}, [],
                          ProcFailedError(f"pool worker rank {r} is gone"))
        return p

    def _cast(self, ranks, meta: dict) -> None:
        """Fire-and-forget control frame (register/rebind/revoke_ns):
        ordering with later ops on the same worker is the socket's FIFO."""
        with self._dispatch_lock:
            for r in ranks:
                with self._links_lock:
                    link = self._links.get(r)
                if link is None:
                    continue
                try:
                    protocol.send_frame(link.sock, protocol.OP, dict(meta))
                except protocol.Disconnect:
                    pass

    @staticmethod
    def _await(p: _Pending, timeout: float, what: str):
        if not p.event.wait(timeout):
            raise SessionError(f"{what} timed out on the procs pool "
                               f"after {timeout:.0f}s")
        if p.error is not None:
            raise p.error
        return p

    def _warm(self) -> None:
        cid = next(self._pool_cid)
        group = tuple(range(self.nranks))
        comm = _PoolComm(group, cid, name="serve-warm")
        with self._comms_lock:
            self._comms[cid] = comm
        self.base_comm = comm
        p = self._request(list(group), {"wop": "warm", "cid": cid,
                                        "group": list(group)})
        self._await(p, self.START_TIMEOUT, "pool warm-up")

    def shutdown(self) -> None:
        self._stop.set()
        with self._links_lock:
            links = list(self._links.values())
            self._links.clear()
        for link in links:
            link.closing = True
            try:
                protocol.send_frame(link.sock, protocol.OP,
                                    {"wop": "shutdown"})
            except (protocol.Disconnect, OSError):
                pass
        for link in links:
            try:
                link.sock.close()
            except OSError:
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        deadline = time.monotonic() + 20
        for pr in self._procs:
            try:
                pr.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pr.kill()
                try:
                    pr.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
        if self._rdv is not None:
            try:
                self._rdv.close(sweep=True)
            except Exception:      # noqa: BLE001 - teardown best-effort
                pass

    # -- elastic membership --------------------------------------------------
    def healthy(self) -> List[int]:
        return [r for r in self.active if r not in self.failed]

    def dead_in(self, group) -> tuple:
        return tuple(sorted(set(group) & self.failed))

    def mark_failed(self, rank: int) -> bool:
        """Failure verdict (control-socket EOF, or an idle retire): the
        workers' own heartbeat plane unblocks their in-flight collectives;
        broker-side there is nothing to poke — just the membership books."""
        if rank in self.failed or rank not in self.active:
            return False
        self.failed.add(rank)
        return True

    # -- comm registry -------------------------------------------------------
    def register_comm(self, group, cid, tenant: str):
        group = tuple(group)
        comm = _PoolComm(group, cid, name=f"serve:{tenant}")
        with self._comms_lock:
            self._comms[cid] = comm
        self._cast(group, {"wop": "register", "cid": cid,
                           "group": list(group)})
        return comm

    def comm_for(self, cid):
        with self._comms_lock:
            return self._comms.get(cid)

    def drop_comm(self, cid) -> None:
        with self._comms_lock:
            self._comms.pop(cid, None)

    def rebind_comm(self, cid, group, tenant: Optional[str]):
        """Elastic rebind, procs flavor: the broker-side (group, cid) pair
        is swapped and every member worker re-registers the SAME cid on the
        remapped group (stale channel dropped worker-side)."""
        group = tuple(group)
        comm = _PoolComm(group, cid, name=f"serve:{tenant or 'pool'}")
        with self._comms_lock:
            self._comms[cid] = comm
        self._cast(group, {"wop": "rebind", "cid": cid,
                           "group": list(group)})
        return comm

    # -- elastic resize primitives (driven by tpu_mpi_torch.elastic) ----------------
    def adopt_base(self, comm) -> None:
        with self._comms_lock:
            self._comms[comm.cid] = comm
        self.base_comm = comm
        self.active = list(comm.group)

    def shrink_base(self) -> tuple:
        """Collapse the pool-wide comm to its survivors. The broker is the
        failure authority here: it ships the declared-dead set with the
        shrink frame, so a drain-and-retire (worker alive, just idle) walks
        the same ULFM path a SIGKILL does; the retiree is then told to shut
        down instead of being conscripted (it is a real process — unlike
        the thread tier, it CAN die independently)."""
        base = self.base_comm
        group = list(base.group)
        survivors = [r for r in group if r not in self.failed]
        dead = tuple(r for r in group if r in self.failed)
        p = self._request(survivors, {"wop": "shrink", "cid": base.cid,
                                      "dead": list(dead)})
        self._await(p, 120.0, "pool shrink")
        meta, _ = p.replies[survivors[0]]
        shrunk = _PoolComm(tuple(meta["group"]), _cidify(meta["cid"]),
                           name=f"{base.name}.shrink")
        for r in dead:
            self.retired.add(r)
            self._close_link(r)
        self.adopt_base(shrunk)
        return shrunk, dead

    def _close_link(self, rank: int) -> None:
        with self._links_lock:
            link = self._links.pop(rank, None)
        if link is None:
            return
        link.closing = True
        try:
            protocol.send_frame(link.sock, protocol.OP, {"wop": "shutdown"})
        except (protocol.Disconnect, OSError):
            pass
        try:
            link.sock.close()
        except OSError:
            pass

    def grow_base(self, n: int) -> tuple:
        """GROW on real processes: survivors Comm_spawn n replacement
        worker processes (serve.worker._pool_child_entry) and merge; each
        child dials the broker's pool socket itself — the address rides the
        spawn environment. Completion = survivor replies AND every new
        rank's HELLO."""
        base = self.base_comm
        survivors = [r for r in base.group if r not in self.failed]
        p = self._request(survivors, {"wop": "grow", "cid": base.cid,
                                      "n": int(n)})
        self._await(p, self.START_TIMEOUT, "pool grow")
        meta, _ = p.replies[survivors[0]]
        merged = _PoolComm(tuple(meta["group"]), _cidify(meta["cid"]),
                           name=f"{base.name}.merge")
        new_ranks = tuple(r for r in merged.group if r not in base.group)
        self._wait_links(new_ranks, self.START_TIMEOUT)
        self.adopt_base(merged)
        return merged, new_ranks

    def elastic_round(self, op: str, epoch: int) -> None:
        comm = self.base_comm
        declared = tuple(comm.group)
        p = self._request(list(declared),
                          {"wop": "round", "cid": comm.cid, "op": op,
                           "epoch": epoch, "declared": list(declared)})
        self._await(p, 120.0, f"elastic {op} round")

    # -- op execution --------------------------------------------------------
    def run_op(self, op: PoolOp, on_done) -> None:
        comm = self.comm_for(op.cid)
        if comm is None:
            op.error = SessionError(f"cid {op.cid} has no live communicator")
            on_done(op)
            return
        group = comm.group
        if op.kind == "dup":
            # broker-side on this tier: cid allocation is pure broker
            # bookkeeping, workers just register the fresh cid (FIFO keeps
            # it ahead of any op the tenant issues on it)
            try:
                ns = self.ctx.cid_namespaces.get(op.tenant)
                if ns is None:
                    raise SessionError(f"tenant {op.tenant!r} has no leased "
                                       f"cid namespace on this broker")
                new_cid = ns.alloc()
            except MPIError as e:
                op.error = e
                on_done(op)
                return
            self._cast(group, {"wop": "register", "cid": new_cid,
                               "group": list(group)})
            op.results = [_PoolComm(group, new_cid,
                                    name=f"serve:{op.tenant}.dup")]
            on_done(op)
            return
        metas: list = []
        arrays: list = []
        if op.kind in ("allreduce", "bcast", "barrier"):
            for i in range(len(group)):
                m = {"wop": "coll", "cid": op.cid, "kind": op.kind, "i": i,
                     "reduce": op.reduce, "root": op.root, "ret": i == 0}
                if op.kind == "allreduce":
                    # per-rank scatter: each worker receives only ITS part,
                    # forwarded as a view of the client's frame (zero-copy)
                    a = [op.parts[i] if len(op.parts) > 1 else op.parts[0]]
                elif op.kind == "bcast" and i == op.root:
                    a = [op.parts[0]]
                else:
                    if op.kind == "bcast":
                        m["desc"] = {"dtype": op.parts[0].dtype.str,
                                     "shape": list(op.parts[0].shape)}
                    a = []
                metas.append(m)
                arrays.append(a)
        elif op.kind == "free":
            metas = [{"wop": "free", "cid": op.cid}] * len(group)
            arrays = [()] * len(group)
        else:
            op.error = MPIError(f"unknown serve op kind {op.kind!r}",
                                code=_ec.ERR_ARG)
            on_done(op)
            return

        def cb(p: _Pending) -> None:
            if p.error is not None:
                op.error = p.error
            else:
                _, arr0 = p.replies.get(group[0], ({}, []))
                op.results = [np.asarray(arr0[0]) if arr0 else None]
            on_done(op)

        self._request(list(group), metas, arrays, cb=cb)

    # -- namespace plumbing (broker-local books on this tier) -----------------
    def lease_ns(self, tenant: str, span: int):
        with self.ctx._ns_lock:
            if tenant in self.ctx.cid_namespaces:
                raise SessionError(f"tenant {tenant!r} already holds a lease "
                                   f"on this broker")
            base = self.ctx._ns_next_base
            if base + span > self.ctx._ns_limit:
                raise SessionError(
                    f"broker cid shard {self.shard!r} exhausted — no room "
                    f"for a {span}-cid namespace")
            self.ctx._ns_next_base += span
            ns = CidNamespace(tenant, base, base + span)
            self.ctx.cid_namespaces[tenant] = ns
            return ns

    def release_ns(self, tenant: str) -> list:
        with self.ctx._ns_lock:
            ns = self.ctx.cid_namespaces.pop(tenant, None)
        if ns is None:
            return []
        self.ctx.revoked_cids.update(range(ns.base, ns._next))
        self._cast(tuple(self.healthy()),
                   {"wop": "revoke_ns", "base": ns.base, "limit": ns._next})
        return []

    def snapshot_pvars(self) -> dict:
        """Fleet pvar snapshot: the broker-local blocks (serve_frame lives
        here) merged with every healthy worker's — comm records concatenate
        (attribution folds them by cid), serve_frame counters sum."""
        from .. import perfvars
        snap = perfvars.snapshot()
        comms = list(snap.get("comms") or [])
        frame = dict(snap.get("serve_frame") or {})
        ranks = self.healthy()
        if ranks:
            p = self._request(list(ranks), {"wop": "pvars"})
            try:
                self._await(p, 30.0, "pool pvar snapshot")
            except MPIError:
                pass                       # degrade: report what arrived
            for r in ranks:
                rep = p.replies.get(r)
                if rep is None:
                    continue
                ws = rep[0].get("snapshot") or {}
                comms.extend(ws.get("comms") or [])
                for k, v in (ws.get("serve_frame") or {}).items():
                    frame[k] = frame.get(k, 0) + int(v)
        snap["comms"] = comms
        snap["serve_frame"] = frame
        return snap

    def info(self) -> dict:
        with self._links_lock:
            workers = {r: link.pid for r, link in sorted(self._links.items())}
        return {"kind": self.kind, "nranks": self.nranks,
                "active": list(self.active), "failed": sorted(self.failed),
                "capacity": len(self.healthy()),
                "comms": len(self._comms),
                "shard": [self.shard.base, self.shard.limit],
                "pool_addr": self.pool_addr, "workers": workers,
                "device": str(self.device)}


class Lease:
    """A tenant's live attachment: its namespace, its communicators, and
    the socket the handler serves it on."""

    __slots__ = ("tenant", "ns", "group", "root_cid", "comms", "conn",
                 "send_lock", "attached_at", "revoked")

    def __init__(self, tenant: str, ns, group, root_cid: int, conn):
        self.tenant = tenant
        self.ns = ns
        self.group = tuple(group)
        self.root_cid = root_cid
        self.comms = {root_cid}           # cids this lease may touch
        self.conn = conn
        self.send_lock = locksmith.make_lock(f"lease[{tenant}].send")
        self.attached_at = time.time()
        self.revoked = False


class Broker:
    """The serve daemon: listener + dispatcher + per-client handlers over
    one warm pool. Construct, :meth:`start`, then :meth:`serve_forever`
    (or drive :meth:`handle_connection` from tests)."""

    def __init__(self, nranks: int = 4, socket_spec: Optional[str] = None,
                 *, token: Optional[str] = None,
                 max_tenants: Optional[int] = None,
                 quota_bytes: Optional[int] = None,
                 quantum: int = 1 << 16, max_depth: int = 64,
                 max_inflight: int = 2, ns_span: int = 256,
                 infer=None, elastic=None,
                 backend: Optional[str] = None,
                 transport: Optional[str] = None,
                 shard=None, device: Any = "cuda"):
        cfg = config.load()
        self.token = cfg.session_token if token is None else token
        self.max_tenants = (cfg.serve_max_tenants if max_tenants is None
                            else int(max_tenants))
        backend = (cfg.serve_backend if backend is None else backend) \
            or "threads"
        self.backend = backend
        transport = (cfg.serve_transport if transport is None
                     else transport) or "events"
        if transport not in ("events", "threads"):
            raise MPIError(
                f"unknown serve transport {transport!r} "
                f"(TPU_MPI_SERVE_TRANSPORT: 'events' or 'threads')",
                code=_ec.ERR_ARG)
        self.transport = transport
        self.front_door = None         # FrontDoor when transport == "events"
        if not isinstance(shard, CidShard):
            shard = CidShard.parse(cfg.serve_shard if shard is None
                                   else shard)
        self.shard = shard
        if backend == "procs":
            self.pool = _ProcsPool(nranks, shard=shard,
                                   on_failure=self.on_rank_failure,
                                   device=device)
        elif backend == "threads":
            self.pool = _ThreadPool(nranks, shard=shard, device=device)
        else:
            raise MPIError(
                f"unknown serve backend {backend!r} "
                f"(TPU_MPI_SERVE_BACKEND: 'threads' or 'procs')",
                code=_ec.ERR_ARG)
        self.fq = FairQueue(quantum=quantum, max_depth=max_depth,
                            max_inflight=max_inflight)
        self.ledger = Ledger(cfg.serve_quota_bytes if quota_bytes is None
                             else int(quota_bytes))
        self.ns_span = int(ns_span)
        self._socket_spec = (cfg.serve_socket if socket_spec is None
                             else socket_spec)
        self._listener: Optional[socket.socket] = None
        self.address: Optional[str] = None
        self._leases: Dict[str, Lease] = {}
        self._lease_lock = locksmith.make_lock("broker.leases")
        # cid-range ownership outlives the lease so pvar attribution in the
        # ledger stays correct after revocation
        self._cid_ranges: List[tuple] = []    # (base, limit, tenant)
        self._oid = itertools.count(1)
        self._tenant_seq = itertools.count(1)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.started = threading.Event()
        # inference engine (tpu_mpi_torch.infer): None = off; True or a kwarg
        # dict for InferEngine = build it at start()
        self._infer_spec = infer
        self.infer_engine = None
        self._infer_sched = None
        # elastic capacity (tpu_mpi_torch.elastic): None = TPU_MPI_ELASTIC config
        self._elastic_spec = cfg.elastic if elastic is None else bool(elastic)
        self._resize_gate = threading.Event()  # set = attaches may proceed
        self._resize_gate.set()
        self.elastic = None                    # ElasticController when on
        self.sidecars = None
        self._elastic_lock = locksmith.make_lock("broker.elastic")
        self.elastic_state = {"enabled": bool(self._elastic_spec),
                              "resizes": 0, "rebinds": 0, "failures": 0,
                              "last_resize": None}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Warm the pool, bind the socket, start dispatcher + acceptor."""
        if self._infer_spec and self.pool.kind != "threads":
            raise MPIError(
                "tpu_mpi_torch.infer runs on the thread backend only — start the "
                "broker with TPU_MPI_SERVE_BACKEND=threads (or shard infer "
                "tenants onto a threads broker behind the router)",
                code=_ec.ERR_UNSUPPORTED_OPERATION)
        if locksmith.enabled():
            # dispatch-named lock transitions land in the event IR so
            # `analyze verify` can audit dispatch serialization (T215)
            locksmith.bind_context(self.pool.ctx)
        self.pool.start()
        if self._infer_spec:
            from ..infer import InferEngine, InferScheduler
            spec = (dict(self._infer_spec)
                    if isinstance(self._infer_spec, dict) else {})
            self.infer_engine = InferEngine(self.pool, **spec)
            self.infer_engine.start()
            self._infer_sched = InferScheduler(self.infer_engine)
            self._infer_sched.start()
        if self._elastic_spec:
            from ..elastic import ElasticController
            self.elastic = ElasticController(self)
            # sidecars model per-rank process death for THREAD ranks; procs
            # workers are real processes — control-socket EOF is the detector
            if config.load().elastic_sidecars and self.pool.kind == "threads":
                from ..elastic.sidecar import RankSidecars
                self.sidecars = RankSidecars(self.pool.active,
                                             on_death=self.on_rank_failure)
                self.sidecars.start()
            self.elastic.start()
        self._listener, self.address = protocol.listen(self._socket_spec)
        self._listener.settimeout(0.2)
        if self.transport == "events":
            from .frontdoor import FrontDoor
            self.front_door = FrontDoor(self, self._listener)
            self.front_door.start()
        d = threading.Thread(target=self._dispatch_loop,
                             name="serve-dispatch", daemon=True)
        d.start()
        self._threads.append(d)
        self.started.set()

    def serve_forever(self) -> None:
        if self.front_door is not None:
            # events transport: this thread becomes the readiness loop;
            # no per-connection threads are ever spawned
            self.front_door.serve_forever()
            return
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self.handle_connection, args=(conn,),
                                 name="serve-client", daemon=True)
            t.start()
            self._threads.append(t)

    def run_in_thread(self) -> threading.Thread:
        """start() + serve_forever() on a daemon thread (tests, examples)."""
        self.start()
        t = threading.Thread(target=self.serve_forever, name="serve-accept",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def close(self) -> None:
        self._stop.set()
        if self.front_door is not None:
            self.front_door.close()
        if self.elastic is not None:
            self.elastic.close()
        if self.sidecars is not None:
            self.sidecars.close()
        with self._lease_lock:
            leases = list(self._leases.values())
        for lease in leases:
            self.revoke_lease(lease, "broker shutting down")
        if self._infer_sched is not None:
            self._infer_sched.close()
        self.fq.close()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self.pool.shutdown()

    # -- dispatcher ----------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            op = self.fq.pop(timeout=0.2)
            if op is None:
                continue
            # trace the dispatcher's global initiation order: explore uses
            # these to label schedules, and their single-threaded origin is
            # the invariant that keeps cross-cid initiation orders aligned
            _ev.record_serve(self.pool.ctx, "dispatch", cid=op.cid,
                             tenant=op.tenant, kind=op.kind, oid=op.oid,
                             nbytes=op.nbytes)
            if _flight.enabled():
                # the crash dump must NAME the in-flight op: when a rank
                # dies mid-collective this is the last dispatch in the ring
                _flight.note("op_dispatch", tenant=op.tenant, op=op.kind,
                             oid=op.oid, cid=op.cid, nbytes=op.nbytes)
            if op.trace is not None and op.t_submit is not None:
                # the fair-queue wait, reconstructed at pop time: DRR decided
                # when this op's tenant got its turn
                _tc.emit_span(op.trace, "queue", "broker", op.t_submit,
                              time.perf_counter(), tenant=op.tenant,
                              kind=op.kind, oid=op.oid)
            if op.kind == "generate":
                # DRR decided its admission slot; the scheduler batches it
                # from here — the fq slot frees immediately so a streaming
                # generation never starves the tenant's collective lane
                self._op_done(op)
                continue
            self.pool.run_op(op, self._op_done)
            del op      # don't pin the payload across the next blocking pop

    def _op_done(self, op: PoolOp) -> None:
        self.fq.complete(op)
        op.done.set()

    # -- degraded-pool serving (tpu_mpi_torch.elastic) ------------------------------
    def on_rank_failure(self, rank: int) -> None:
        """Failure-detector verdict (sidecar death, or a test's injection):
        declare the rank dead and KEEP SERVING — tenants whose comms avoid
        the dead rank stream on, ops that span it get the retriable
        :class:`PoolDegradedError`, and the elastic controller (when on)
        schedules the restore resize."""
        if not self.pool.mark_failed(rank):
            return
        with self._elastic_lock:
            self.elastic_state["failures"] += 1
        from .. import perfvars
        if perfvars.enabled():
            perfvars.note_elastic(failures=1)
            perfvars.set_elastic_gauges(degraded=1,
                                        pool_size=len(self.pool.healthy()))
        _ev.record_serve(self.pool.ctx, "rank_failed", rank=rank,
                         capacity=len(self.pool.healthy()))
        if self.elastic is not None:
            self.elastic.kick()

    def _degraded_error(self, tenant: Optional[str],
                        group=None) -> PoolDegradedError:
        dead = (self.pool.dead_in(group) if group is not None
                else tuple(sorted(self.pool.failed)))
        headroom = len(self.pool.healthy())
        return PoolDegradedError(
            f"serve pool degraded: rank(s) {list(dead)} failed and are not "
            f"yet replaced ({headroom} healthy ranks remain) — retry once "
            f"the autoscaler restores capacity and rebinds the lease",
            tenant=tenant, dead=dead, headroom=headroom)

    def _elastic_section(self) -> dict:
        with self._elastic_lock:
            st = dict(self.elastic_state)
        healthy = len(self.pool.healthy())
        st.update({
            "pool_size": healthy,
            "target_size": (self.elastic.target if self.elastic is not None
                            else self.pool.nranks),
            "degraded": bool(self.pool.failed - self.pool.retired),
            "failed": sorted(self.pool.failed),
            # re-advertised capacity: ranks a NEW lease can span right now
            "headroom": healthy})
        return st

    # -- attach / leases -----------------------------------------------------
    def _check_token(self, supplied: Optional[str]) -> None:
        if not self.token:
            return                            # open broker ("" accepts any)
        if not hmac.compare_digest(str(supplied or ""), self.token):
            raise SessionError("session token rejected "
                               "(TPU_MPI_SESSION_TOKEN mismatch)")

    def attach_tenant(self, conn, meta: dict) -> Lease:
        t0_span = time.perf_counter()
        self._check_token(meta.get("token"))
        # a resize holds the gate while the rank map is in flux: attaches
        # queue here and land on the post-resize pool (tests drive this)
        if not self._resize_gate.wait(timeout=30.0):
            raise SessionError("attach timed out waiting for an elastic "
                               "resize to finish")
        with self._lease_lock:
            if len(self._leases) >= self.max_tenants:
                raise SessionError(
                    f"broker at max_tenants={self.max_tenants} "
                    f"(TPU_MPI_SERVE_MAX_TENANTS) — detach a tenant first")
            tenant = meta.get("tenant") or f"t{next(self._tenant_seq)}"
            if tenant in self._leases:
                raise SessionError(f"tenant id {tenant!r} already attached")
            healthy = self.pool.healthy()
            nranks = int(meta.get("nranks") or len(healthy))
            if not 1 <= nranks <= max(self.pool.nranks, len(healthy)):
                raise SessionError(
                    f"requested nranks={nranks} outside pool size "
                    f"{max(self.pool.nranks, len(healthy))}")
            if nranks > len(healthy):
                # the pool COULD host this lease, just not until the
                # autoscaler restores the dead ranks: typed + retriable
                raise self._degraded_error(tenant)
            ns = self.pool.lease_ns(tenant, self.ns_span)
            self._cid_ranges.append((ns.base, ns.limit, tenant))
            # nothing collective below: root cid is a broker-side alloc, so
            # attach stays on the <1 ms budget
            root_cid = ns.alloc()
            group = tuple(healthy[:nranks])
            self.pool.register_comm(group, root_cid, tenant)
            lease = Lease(tenant, ns, group, root_cid, conn)
            self._leases[tenant] = lease
        self.fq.add_tenant(tenant)
        self.ledger.open_tenant(tenant)
        _ev.record_serve(self.pool.ctx, "lease", cid=root_cid, tenant=tenant,
                         base=ns.base, limit=ns.limit)
        ctx = _tc.TraceCtx.from_meta(meta)
        if ctx is not None and ctx.sampled:
            _tc.emit_span(ctx, "broker:attach", "broker", t0_span,
                          time.perf_counter(), tenant=tenant)
        return lease

    def revoke_lease(self, lease: Lease, reason: str, *,
                     close_conn: bool = True) -> None:
        """Reclaim everything a dead/departing tenant held: queued ops are
        failed, its cid range is drained + revoked on the warm context
        (stragglers raise, never hang), its comms and plan-cache entries
        dropped, its ledger books closed. The pool itself stays healthy."""
        with self._lease_lock:
            if self._leases.get(lease.tenant) is not lease:
                return                        # already revoked
            del self._leases[lease.tenant]
            lease.revoked = True
        for op in self.fq.remove_tenant(lease.tenant):
            op.error = SessionError(
                f"lease for tenant {lease.tenant!r} revoked ({reason}) "
                f"before the op dispatched")
            op.done.set()
        if self._infer_sched is not None:
            # in-flight generations leave the batch; their KV chains free
            # on the next step — survivors keep streaming
            self._infer_sched.cancel_tenant(lease.tenant)
        self.pool.release_ns(lease.tenant)
        from ..overlap import plans
        for cid in list(lease.comms):
            self.pool.drop_comm(cid)
            plans.invalidate(cid)
        self.ledger.close_tenant(lease.tenant,
                                 revoked=reason != "client detached")
        _ev.record_serve(self.pool.ctx, "lease_revoke", tenant=lease.tenant,
                         reason=reason, base=lease.ns.base,
                         limit=lease.ns.limit)
        if _flight.enabled():
            _flight.note("lease_revoke", tenant=lease.tenant, reason=reason)
            if reason != "client detached":
                # involuntary revocation: snapshot the ring so whoever
                # debugs the eviction sees the seconds leading up to it
                _flight.auto_dump("lease-revoke")
        if close_conn:
            try:
                lease.conn.close()
            except OSError:
                pass

    # -- per-connection protocol loop ----------------------------------------
    def handle_connection(self, conn: socket.socket) -> None:
        try:
            kind, meta, _ = protocol.recv_frame(conn)
        except (protocol.Disconnect, SessionError):
            conn.close()
            return
        if kind == protocol.STATS:
            # lease-less admin probe (tpurun-torch --serve --stats)
            try:
                self._check_token(meta.get("token"))
                protocol.send_frame(conn, protocol.STATS, self.stats())
            except MPIError as e:
                protocol.send_frame(conn, protocol.ERROR,
                                    protocol.error_meta(e))
            finally:
                conn.close()
            return
        if kind == protocol.METRICS:
            # lease-less Prometheus scrape: the text exposition of the same
            # snapshot STATS returns (docs/observability.md "Live export")
            try:
                self._check_token(meta.get("token"))
                from .. import stats as _stats
                protocol.send_frame(conn, protocol.METRICS,
                                    {"text": _stats.to_prometheus(
                                        self.stats())})
            except MPIError as e:
                protocol.send_frame(conn, protocol.ERROR,
                                    protocol.error_meta(e))
            finally:
                conn.close()
            return
        if kind != protocol.HELLO:
            protocol.send_frame(conn, protocol.ERROR, protocol.error_meta(
                SessionError(f"expected HELLO, got "
                             f"{protocol.KIND_NAMES.get(kind, kind)}")))
            conn.close()
            return
        t0 = time.perf_counter()
        try:
            lease = self.attach_tenant(conn, meta)
        except MPIError as e:
            protocol.send_frame(conn, protocol.ERROR, protocol.error_meta(e))
            conn.close()
            return
        attach_us = (time.perf_counter() - t0) * 1e6
        protocol.send_frame(conn, protocol.LEASE, {
            "tenant": lease.tenant, "ranks": list(lease.group),
            "cid": lease.root_cid,
            "cid_base": lease.ns.base, "cid_limit": lease.ns.limit,
            "pool": self.pool.info(), "attach_us": attach_us})
        detached = False
        try:
            while True:
                kind, meta, arrays = protocol.recv_frame(conn)
                if kind == protocol.DETACH:
                    detached = True
                    # book the lease out BEFORE replying so a client that
                    # inspects broker state right after BYE sees it settled
                    self.revoke_lease(lease, "client detached",
                                      close_conn=False)
                    protocol.send_frame(conn, protocol.BYE,
                                        {"tenant": lease.tenant})
                    break
                if kind == protocol.PING:
                    with lease.send_lock:
                        protocol.send_frame(conn, protocol.PONG, {})
                    continue
                if kind == protocol.STATS:
                    with lease.send_lock:
                        protocol.send_frame(conn, protocol.STATS, self.stats())
                    continue
                if kind == protocol.METRICS:
                    from .. import stats as _stats
                    text = _stats.to_prometheus(self.stats())
                    with lease.send_lock:
                        protocol.send_frame(conn, protocol.METRICS,
                                            {"text": text})
                    continue
                if kind != protocol.OP:
                    raise SessionError(
                        f"unexpected {protocol.KIND_NAMES.get(kind, kind)} "
                        f"frame mid-session")
                self._serve_op(lease, meta, arrays)
        except (protocol.Disconnect, SessionError, OSError):
            pass
        finally:
            self.revoke_lease(lease, "client detached" if detached
                              else "connection lost")
            try:
                conn.close()
            except OSError:
                pass

    def _serve_op(self, lease: Lease, meta: dict, arrays: list) -> None:
        if meta.get("op") == "generate":
            self._serve_generate(lease, meta, arrays)
            return
        try:
            reply_meta, reply_arrays = self._admit_and_run(lease, meta,
                                                           arrays)
        except MPIError as e:
            # typed rejection (quota, busy, session, arg): one tenant's
            # ERROR frame, never a pool failure
            with lease.send_lock:
                protocol.send_frame(lease.conn, protocol.ERROR,
                                    protocol.error_meta(e))
            return
        with lease.send_lock:
            protocol.send_frame(lease.conn, protocol.RESULT, reply_meta,
                                reply_arrays)

    def _admit_and_run(self, lease: Lease, meta: dict, arrays: list):
        """Traced wrapper: open the broker's span for a sampled request
        (everything downstream — queue wait, per-rank phases — nests under
        it), run admission + execution, and close it ok/error. An untraced
        request pays one dict lookup."""
        ctx = _tc.TraceCtx.from_meta(meta)
        if ctx is None:
            return self._admitted(lease, meta, arrays, None)
        rec = _tc.start_span(ctx, f"broker:{meta.get('op')}", "broker",
                             tenant=lease.tenant)
        try:
            reply_meta, reply_arrays = self._admitted(
                lease, meta, arrays, _tc.child_for_span(rec, ctx))
        except BaseException as e:
            _tc.end_span(rec, status="error", error=type(e).__name__)
            raise
        _tc.end_span(rec)
        # RESULT frames echo the context so a client (or mid-path proxy)
        # can stitch replies to requests without a side table
        reply_meta["trace"] = ctx.to_meta()
        return reply_meta, reply_arrays

    def _admitted(self, lease: Lease, meta: dict, arrays: list,
                  tctx: Optional[_tc.TraceCtx]):
        opname = meta.get("op")
        cid = int(meta.get("cid", lease.root_cid))
        if cid not in lease.comms:
            raise SessionError(
                f"tenant {lease.tenant!r} used cid {cid} outside its lease "
                f"(owns {sorted(lease.comms)}; namespace "
                f"[{lease.ns.base}, {lease.ns.limit})) — cross-tenant "
                f"communicator use is forbidden")
        # management ops that never touch the rank workers
        if opname == "pcontrol":
            level = int(meta.get("level", 1))
            totals = self.flush_ledger() if level >= 2 else None
            return {"op": opname, "level": level, "totals": totals}, []
        # degraded-pool guard: an op whose communicator spans a declared-
        # dead rank is rejected typed-and-retriable at admission — it would
        # only raise ProcFailedError from the rank workers (reject, don't
        # burn a pool slot). Comms on surviving ranks pass untouched.
        comm = self.pool.comm_for(cid)
        if comm is not None and self.pool.dead_in(comm.group):
            raise self._degraded_error(lease.tenant, comm.group)
        if opname in ("allreduce", "bcast"):
            self._validate_arrays(lease, opname, arrays, meta)
            if opname == "allreduce":
                _reduce_op(str(meta.get("reduce", "sum")))
        elif opname in ("barrier", "dup", "free"):
            if opname == "free" and cid == lease.root_cid:
                raise SessionError("the lease's root communicator is freed "
                                   "by DETACH, not by an explicit free")
            arrays = []
        else:
            raise MPIError(f"unknown serve op {opname!r}", code=_ec.ERR_ARG)
        op = PoolOp(next(self._oid), lease.tenant, opname, cid,
                    [np.asarray(a) for a in arrays],
                    str(meta.get("reduce", "sum")),
                    int(meta.get("root", 0)))
        op.trace = tctx
        if opname in ("allreduce", "bcast"):
            # admission book is the quota authority; breach = typed reject
            self.ledger.charge(lease.tenant, op.nbytes)
        try:
            op.t_submit = time.perf_counter()
            self.fq.submit(op)
        except MPIError as e:
            if getattr(e, "retriable", False):
                self.ledger.note_busy(lease.tenant)
            raise
        if not op.done.wait(timeout=120.0):
            raise SessionError(f"op {opname} (oid={op.oid}) timed out on "
                               f"the pool")
        if op.error is not None:
            err = op.error
            if isinstance(err, ProcFailedError):
                # a rank died while the op was in flight: same contract as
                # the admission guard — typed, retriable, lease intact
                raise self._degraded_error(lease.tenant) from err
            if isinstance(err, MPIError):
                raise err
            raise MPIError(f"pool execution failed: {err}",
                           code=_ec.ERR_OTHER)
        return self._reply_for(lease, op)

    # -- streaming generation (tpu_mpi_torch.infer) --------------------------------
    def _serve_generate(self, lease: Lease, meta: dict,
                        arrays: list) -> None:
        """One generation request, streamed: admission (quota + fair
        queue) then repeated RESULT frames ``{"stream": True, "tokens":
        [...], "done": bool}`` as the scheduler emits tokens. Typed errors
        (SLO eviction, revocation) arrive as a terminal ERROR frame."""
        ctx = _tc.TraceCtx.from_meta(meta)
        rec = _tc.start_span(ctx, "broker:generate", "broker",
                             tenant=lease.tenant)
        try:
            req = self._admit_generate(lease, meta, arrays,
                                       tctx=_tc.child_for_span(rec, ctx))
        except MPIError as e:
            _tc.end_span(rec, status="error", error=type(e).__name__)
            with lease.send_lock:
                protocol.send_frame(lease.conn, protocol.ERROR,
                                    protocol.error_meta(e))
            return
        while True:
            try:
                kind, payload = req.out.get(timeout=300.0)
            except queue.Empty:
                kind, payload = "err", SessionError(
                    f"generation rid={req.rid} stalled on the engine")
            if kind == "tok":
                with lease.send_lock:
                    protocol.send_frame(
                        lease.conn, protocol.RESULT,
                        {"op": "generate", "rid": req.rid, "stream": True,
                         "done": False,
                         "tokens": [int(t) for t in payload]})
            elif kind == "done":
                _tc.end_span(rec, rid=req.rid)
                done_meta = {"op": "generate", "rid": req.rid,
                             "stream": True, "done": True, "tokens": [],
                             **payload}
                if ctx is not None and ctx.sampled:
                    done_meta["trace"] = ctx.to_meta()
                with lease.send_lock:
                    protocol.send_frame(lease.conn, protocol.RESULT,
                                        done_meta)
                return
            else:
                _tc.end_span(rec, status="error",
                             error=type(payload).__name__)
                with lease.send_lock:
                    protocol.send_frame(lease.conn, protocol.ERROR,
                                        protocol.error_meta(payload))
                return

    def _admit_generate(self, lease: Lease, meta: dict, arrays: list,
                        tctx: Optional[_tc.TraceCtx] = None):
        if self._infer_sched is None:
            raise MPIError(
                "this broker has no inference engine (start it with "
                "tpurun-torch --serve --infer, or Broker(infer=True))",
                code=_ec.ERR_UNSUPPORTED_OPERATION)
        if self.infer_engine is not None \
                and self.pool.dead_in(self.infer_engine.ranks):
            # the engine's pipeline spans the dead rank; generation resumes
            # once the resize rebinds the engine onto the replacements
            raise self._degraded_error(lease.tenant, self.infer_engine.ranks)
        if len(arrays) != 1:
            raise MPIError("generate takes exactly one prompt token array",
                           code=_ec.ERR_ARG)
        prompt = np.asarray(arrays[0])
        if prompt.ndim != 1 or prompt.dtype.kind not in "iu" \
                or prompt.size == 0:
            raise MPIError("generate prompt must be a non-empty 1-D integer "
                           "token array", code=_ec.ERR_ARG)
        cfg = self.infer_engine.cfg
        max_new = int(meta.get("max_new", 16))
        if max_new < 1:
            raise MPIError(f"max_new must be >= 1, got {max_new}",
                           code=_ec.ERR_ARG)
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= cfg.vocab:
            raise MPIError(f"prompt token {lo if lo < 0 else hi} outside "
                           f"vocab [0, {cfg.vocab})", code=_ec.ERR_ARG)
        if int(prompt.size) + max_new > cfg.max_seq:
            raise MPIError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds the "
                f"model's max_seq ({cfg.max_seq})", code=_ec.ERR_ARG)
        # admission charge: prompt bytes in + generated ids out
        nbytes = int(prompt.nbytes) + 8 * max_new
        self.ledger.charge(lease.tenant, nbytes)
        op = PoolOp(next(self._oid), lease.tenant, "generate",
                    lease.root_cid, [], "sum", 0)
        op.nbytes = nbytes
        op.trace = tctx
        try:
            op.t_submit = time.perf_counter()
            self.fq.submit(op)
        except MPIError as e:
            if getattr(e, "retriable", False):
                self.ledger.note_busy(lease.tenant)
            raise
        if not op.done.wait(timeout=120.0):
            raise SessionError(f"generate (oid={op.oid}) timed out in the "
                               f"fair queue")
        if op.error is not None:
            raise op.error
        return self._infer_sched.submit(lease.tenant,
                                        [int(t) for t in prompt], max_new,
                                        tctx=tctx)

    def _validate_arrays(self, lease: Lease, opname: str, arrays: list,
                         meta: dict) -> None:
        """Admission-time shape/dtype agreement: the pool's combine step
        fate-shares on error, so anything that could throw there is
        rejected here instead."""
        if not arrays:
            raise MPIError(f"{opname} needs at least one array",
                           code=_ec.ERR_ARG)
        if opname == "allreduce" and len(arrays) not in (1, len(lease.group)):
            raise MPIError(
                f"allreduce takes 1 replicated part or exactly "
                f"{len(lease.group)} per-rank parts, got {len(arrays)}",
                code=_ec.ERR_ARG)
        if opname == "bcast":
            root = int(meta.get("root", 0))
            if not 0 <= root < len(lease.group):
                raise MPIError(f"bcast root {root} outside comm of size "
                               f"{len(lease.group)}", code=_ec.ERR_ARG)
            if len(arrays) != 1:
                raise MPIError("bcast takes exactly the root's array",
                               code=_ec.ERR_ARG)
        first = arrays[0]
        for a in arrays[1:]:
            if a.shape != first.shape or a.dtype != first.dtype:
                raise MPIError(
                    f"{opname} parts disagree: {a.dtype}{a.shape} vs "
                    f"{first.dtype}{first.shape}", code=_ec.ERR_ARG)

    def _reply_for(self, lease: Lease, op: PoolOp):
        if op.kind == "allreduce":
            # deterministic rank-ordered reduction: every rank's result is
            # bitwise identical; return rank 0's
            return {"op": op.kind, "oid": op.oid}, [op.results[0]]
        if op.kind == "bcast":
            return {"op": op.kind, "oid": op.oid}, [op.results[0]]
        if op.kind == "barrier":
            return {"op": op.kind, "oid": op.oid}, []
        if op.kind == "dup":
            new_comm = op.results[0]
            lease.comms.add(new_comm.cid)
            with self.pool._comms_lock:
                self.pool._comms[new_comm.cid] = new_comm
            return {"op": op.kind, "oid": op.oid, "cid": new_comm.cid}, []
        if op.kind == "free":
            lease.comms.discard(op.cid)
            self.pool.drop_comm(op.cid)
            return {"op": op.kind, "oid": op.oid}, []
        raise MPIError(f"unknown kind {op.kind!r}", code=_ec.ERR_ARG)

    # -- accounting ----------------------------------------------------------
    def _owner_of_cid(self, cid) -> Optional[str]:
        if isinstance(cid, (tuple, list)):   # wire-decoded tuple cids: list
            cid = next((c for c in cid if isinstance(c, int)), None)
        if not isinstance(cid, int):
            return None
        for base, limit, tenant in self._cid_ranges:
            if base <= cid < limit:
                return tenant
        return None

    def _flush_and_report(self) -> tuple:
        """Measured-book flush + report in ONE ledger-lock acquisition
        (Ledger.flush_and_report); the attribution pass runs lock-free."""
        totals, rep = self.ledger.flush_and_report(self.pool.snapshot_pvars(),
                                                   self._owner_of_cid)
        if _ev.enabled():
            # T208 front end: the flushed per-tenant measured rows plus the
            # pool totals and the live cid-ownership map, in one event the
            # trace verifier can re-add and cross-check
            measured = {t: dict(e.get("measured") or {})
                        for t, e in rep["tenants"].items()}
            _ev.record_serve(self.pool.ctx, "book", totals=dict(totals),
                             measured=measured,
                             ranges=[list(r) for r in self._cid_ranges])
        return totals, rep

    def flush_ledger(self) -> dict:
        """Rebuild the measured books from a fresh pvar snapshot; the
        returned pool totals equal the sum over tenants by construction."""
        totals, _ = self._flush_and_report()
        return totals

    def stats(self) -> dict:
        """One STATS snapshot, batched: one ledger-lock acquisition (flush
        + report fused), one queue-stats call, one lease-lock grab — a
        1k-tenant fleet polling stats must not serialize the op path on
        observability."""
        totals, report = self._flush_and_report()
        with self._lease_lock:
            live = sorted(self._leases)
        from ..overlap import plans
        return {"address": self.address, "pool": self.pool.info(),
                "backend": self.pool.kind,
                "transport": self.transport,
                "front_door": (self.front_door.stats()
                               if self.front_door is not None else None),
                "shard": {"index": self.shard.index,
                          "count": self.shard.count,
                          "base": self.shard.base, "limit": self.shard.limit},
                "tenants_attached": live, "totals": totals,
                "ledger": report, "queue": self.fq.stats(),
                "plan_cache": plans.stats(),
                "serve_frame": self._serve_frame_block(),
                "infer": (self._infer_sched.stats()
                          if self._infer_sched is not None else None),
                "elastic": self._elastic_section()}

    def _serve_frame_block(self) -> dict:
        """The zero-copy frame pvars + the derived copies/op ratio the CI
        gate reads (copies per op <= 1 on the zero-copy path)."""
        from .. import perfvars
        frame = dict(perfvars.serve_frame_snapshot())
        ops = int(frame.get("ops", 0))
        frame["copies_per_op"] = (frame.get("copies", 0) / ops) if ops else 0.0
        return frame


# -- tpurun-torch --serve CLI -------------------------------------------------------

def _stats_client(address: str, token: str) -> dict:
    sock = protocol.connect(address)
    try:
        protocol.send_frame(sock, protocol.STATS, {"token": token})
        kind, meta, _ = protocol.recv_frame(sock)
        if kind == protocol.ERROR:
            protocol.raise_for_error(meta)
        return meta
    finally:
        sock.close()


def _metrics_client(address: str, token: str) -> str:
    """One Prometheus scrape: the broker's METRICS frame text."""
    sock = protocol.connect(address)
    try:
        protocol.send_frame(sock, protocol.METRICS, {"token": token})
        kind, meta, _ = protocol.recv_frame(sock)
        if kind == protocol.ERROR:
            protocol.raise_for_error(meta)
        return str(meta.get("text", ""))
    finally:
        sock.close()


def main(argv: Optional[list] = None) -> int:
    """``tpurun-torch --serve [--socket SPEC] [--nranks N] [--device D]
    [--stats]``."""
    import argparse
    p = argparse.ArgumentParser(
        prog="tpurun-torch --serve",
        description="run the multi-tenant broker daemon (docs/serving.md), "
                    "or query a running one with --stats")
    p.add_argument("--socket", default=None,
                   help="serve socket: unix path (contains '/') or host:port "
                        "(default: TPU_MPI_SERVE_SOCKET, else a loopback "
                        "port printed at startup)")
    p.add_argument("--nranks", type=int, default=4,
                   help="warm pool size (default 4)")
    p.add_argument("--token", default=None,
                   help="session token (default: TPU_MPI_SESSION_TOKEN)")
    p.add_argument("--max-tenants", type=int, default=None)
    p.add_argument("--quota-bytes", type=int, default=None)
    p.add_argument("--backend", default=None, choices=["threads", "procs"],
                   help="pool backend (default: TPU_MPI_SERVE_BACKEND, else "
                        "threads): 'procs' runs one OS process per rank on "
                        "the native framed transport")
    p.add_argument("--device", default="cuda",
                   help="where the pool holds and folds tenants' payloads "
                        "(default cuda; 'cpu' runs the pool on the host)")
    p.add_argument("--shard", default=None,
                   help="cid shard 'index/count' for multi-broker scale-out "
                        "(default: TPU_MPI_SERVE_SHARD, else the whole "
                        "range) — brokers of one fleet MUST use distinct "
                        "indices of the same count")
    p.add_argument("--router", action="store_true",
                   help="run the tenant router instead of a broker: shards "
                        "sessions across --brokers by tenant key "
                        "(docs/serving.md 'Scale-out')")
    p.add_argument("--brokers", default=None,
                   help="comma-separated broker sockets (router upstreams, "
                        "or multi-broker --stats; default: "
                        "TPU_MPI_SERVE_BROKERS)")
    p.add_argument("--router-mode", default=None,
                   choices=("splice", "redirect"),
                   help="router session handling: proxy every byte "
                        "(splice) or answer HELLO with the home broker "
                        "(redirect; default: TPU_MPI_SERVE_ROUTER_MODE)")
    p.add_argument("--infer", action="store_true",
                   help="serve token generation (tpu_mpi_torch.infer): a "
                        "2-stage x N-expert MoE engine on the warm pool")
    p.add_argument("--elastic", action="store_true",
                   help="run the elastic autoscaler (tpu_mpi_torch.elastic): "
                        "dead ranks are respawned and merged back, tenant "
                        "leases rebound, and the pool serves degraded in "
                        "between (docs/fault-tolerance.md)")
    p.add_argument("--stats", action="store_true",
                   help="report per-tenant usage of a running broker and "
                        "exit")
    p.add_argument("--watch", action="store_true",
                   help="with --stats: keep polling and stream interval "
                        "deltas/rates (unreachable brokers render an "
                        "error row, the stream continues)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--watch poll interval in seconds (default 2)")
    p.add_argument("--metrics", action="store_true",
                   help="with --stats: print the Prometheus text "
                        "exposition (the METRICS frame) instead of JSON")
    args = p.parse_args(argv)

    cfg = config.load()
    if args.stats:
        # fleet view: --stats accepts one socket, a comma list, --brokers,
        # or TPU_MPI_SERVE_BROKERS; multiple reports merge into one
        # (per-tenant measured books still partition the summed totals)
        spec = (args.brokers or args.socket or cfg.serve_brokers
                or cfg.serve_socket)
        sockets = [s.strip() for s in (spec or "").split(",") if s.strip()]
        if not sockets:
            p.error("--stats needs --socket/--brokers or "
                    "TPU_MPI_SERVE_SOCKET/TPU_MPI_SERVE_BROKERS")
        token = cfg.session_token if args.token is None else args.token
        if args.metrics:
            for s in sockets:
                sys.stdout.write(_metrics_client(s, token))
            return 0
        if args.watch:
            from .. import stats as _stats

            def poll() -> list:
                out = []
                for s in sockets:
                    try:
                        out.append(_stats_client(s, token))
                    except Exception as e:  # noqa: BLE001 - rendered as row
                        out.append({"address": s, "error": str(e)})
                return out

            return _stats.watch_fleet(poll, interval=args.interval)
        reports = [_stats_client(s, token) for s in sockets]
        if len(reports) == 1:
            print(json.dumps(reports[0], indent=2, default=str))
        else:
            from .router import merge_stats
            print(json.dumps(merge_stats(reports), indent=2, default=str))
        return 0

    if args.router:
        from .router import Router
        spec = args.brokers or cfg.serve_brokers
        brokers = [s.strip() for s in (spec or "").split(",") if s.strip()]
        if not brokers:
            p.error("--router needs --brokers or TPU_MPI_SERVE_BROKERS")
        router = Router(brokers,
                        socket_spec=(args.socket or cfg.serve_router_socket
                                     or None),
                        token=args.token, mode=args.router_mode)
        router.start()
        print(f"tpu_mpi_torch serve: router up — {len(brokers)} broker(s), "
              f"mode={router.mode}, socket={router.address} "
              f"(pid {os.getpid()})", flush=True)
        try:
            router.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            router.close()
        return 0

    broker = Broker(nranks=args.nranks, socket_spec=args.socket,
                    token=args.token, max_tenants=args.max_tenants,
                    quota_bytes=args.quota_bytes,
                    infer=True if args.infer else None,
                    elastic=True if args.elastic else None,
                    backend=args.backend, shard=args.shard,
                    device=args.device)
    _flight.install_signal_hook()         # SIGTERM dumps the flight ring
    broker.start()
    print(f"tpu_mpi_torch serve: broker up — pool={args.nranks} ranks "
          f"({broker.pool.kind}, {broker.pool.device}), "
          f"socket={broker.address}, "
          f"shard={broker.shard.index}/{broker.shard.count}"
          + (", inference engine on" if args.infer else "")
          + (", elastic autoscaler on" if args.elastic else "")
          + f" (pid {os.getpid()})", flush=True)
    try:
        broker.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        broker.close()
    return 0
