"""Communicators: ordered device/rank groups bound to the SPMD world.

Reference: MPI.jl src/comm.jl — Comm handle (:6), COMM_NULL/WORLD/SELF
(:8-23), Comm_rank (:49-53), Comm_size (:66-70), Comm_dup (:78-84),
Comm_split (:92-99), Comm_split_type (:107-115), Comm_get_parent (:123-127),
Comm_spawn (:135-147), Intercomm_merge (:155-162), universe_size (:171-181),
Comm_compare + Comparison enum (:197-218).

TPU mapping (SURVEY.md §2.2): a Comm is an ordered subset of the world's ranks
(each rank owning a device); ``Comm_split`` regroups ranks into sub-worlds. A
communicator's *context id* (cid) isolates its point-to-point and collective
traffic, allocated collectively on the parent so all members agree — the analog
of MPI context ids that libmpi manages internally.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

from ._runtime import UNDEFINED, CollectiveChannel, current_env, require_env
from . import error as _ec
from .error import InvalidCommError, MPIError


class Comparison(enum.IntEnum):
    """Result of Comm_compare (src/comm.jl:197-204)."""
    IDENT = 0
    CONGRUENT = 1
    SIMILAR = 2
    UNEQUAL = 3


IDENT = Comparison.IDENT
CONGRUENT = Comparison.CONGRUENT
SIMILAR = Comparison.SIMILAR
UNEQUAL = Comparison.UNEQUAL

# Split type for Comm_split_type (src/comm.jl:107-115): ranks sharing a host.
COMM_TYPE_SHARED = 1

# MPI_ROOT sentinel for rooted intercomm collectives: in the root group, the
# one sourcing rank passes ROOT and the rest pass PROC_NULL; the receiving
# group passes the root's rank within the remote group. (The value is this
# runtime's own sentinel, like _runtime.PROC_NULL — the reference inherits
# libmpi's, consts_mpich.jl.)
ROOT = -4


class Comm:
    """An ordered group of ranks with an isolated communication context.

    ``group[i]`` is the world rank of this communicator's rank i; the calling
    rank's position defines ``Comm_rank``.
    """

    def __init__(self, group: Sequence[int], cid: int, *, ctx=None, name: str = "comm"):
        self._group = tuple(group)
        self._cid = cid
        self._fixed_ctx = ctx
        self.name = name
        self._freed = False
        self._rank_cache: dict[int, int] = {}

    # -- context / group resolution -----------------------------------------
    @property
    def ctx(self):
        if self._fixed_ctx is not None:
            return self._fixed_ctx
        ctx, _ = require_env()
        return ctx

    @property
    def group(self) -> tuple[int, ...]:
        return self._group

    @property
    def cid(self) -> int:
        return self._cid

    def _check(self) -> None:
        if self._freed:
            raise InvalidCommError("operation on a freed communicator")

    def rank(self) -> int:
        self._check()
        _, world_rank = require_env()
        # per-world-rank cache: list.index() on every Send/Recv is
        # measurable on the small-message latency lane
        r = self._rank_cache.get(world_rank)
        if r is None:
            try:
                r = self._group.index(world_rank)
            except ValueError:
                raise InvalidCommError(
                    f"world rank {world_rank} is not a member of "
                    f"{self.name}") from None
            self._rank_cache[world_rank] = r
        return r

    def size(self) -> int:
        self._check()
        return len(self._group)

    def world_rank_of(self, comm_rank: int) -> int:
        """Translate a rank of this communicator to a world rank."""
        return self._group[comm_rank]

    def channel(self) -> CollectiveChannel:
        """The collective rendezvous channel for this communicator."""
        self._check()
        ctx = self.ctx
        if ctx.failed_ranks or ctx.revoked_cids:  # fault path is pay-for-use
            ctx.check_fault(self._cid)
        return ctx.channel(self._cid, len(self._group), group=self._group)

    def get_pvars(self, reset: bool = False) -> dict:
        """This rank's performance-variable snapshot on this communicator
        (docs/observability.md): byte/op counters, per-collective latency
        stats and histograms, host-path phase times, RMA epoch counts.
        ``reset=True`` additionally zeroes the counters (MPI_T pvar
        read-and-reset semantics)."""
        self._check()
        from . import perfvars
        return perfvars.comm_snapshot(self, reset=reset)

    @property
    def device(self):
        """The JAX device owned by the calling rank (SURVEY.md §2.3: buffers
        are device-resident by construction; each rank binds one device)."""
        ctx, world_rank = require_env()
        return ctx.device_for(world_rank)

    def free(self) -> None:
        """Mark the communicator unusable and release this rank's
        nonblocking-collective worker thread, if one was created
        (src/comm.jl MPI_Comm_free analog — no C resources, but the
        I-collective executor is a real thread).

        Freeing under in-flight nonblocking collectives is a typed error
        naming the pending ops — Wait them first. (MPI_Comm_free's deferred
        destruction has no analog here: the worker thread and the plan/
        registry entries go away NOW, so completing the pending ops later
        is impossible; silently shooting them down is how a broker bug
        would masquerade as a tenant bug — docs/serving.md lease
        reclamation depends on telling the two apart.)"""
        pre_env = current_env()
        if pre_env is not None:
            from .collective import nb_pending
            pending = nb_pending(pre_env[0], self._cid, pre_env[1])
            if pending:
                raise MPIError(
                    f"Comm.free on {self.name} (cid={self._cid}) with "
                    f"{len(pending)} in-flight nonblocking op(s): "
                    f"{', '.join(pending)} — Wait/Test them to completion "
                    f"before freeing", code=_ec.ERR_PENDING)
        self._freed = True
        from .overlap import plans, registry
        plans.invalidate(self._cid)   # cached collective plans die with us
        # registered fast path (docs/performance.md "Registered buffers"):
        # plan-pinned wire views, fold scratch and shm slot leases must not
        # outlive the communicator
        registry.release(self._cid)
        env = current_env()
        if env is not None:
            from .collective import nb_shutdown
            ctx, world_rank = env
            nb_shutdown(ctx, cid=self._cid, world_rank=world_rank)
            ch = ctx._channels.get(self._cid) \
                if hasattr(ctx, "_channels") else None
            drop = getattr(ch, "drop_shm", None)
            if drop is not None:
                drop()
        from . import config
        if config.load().strict:
            leaked = registry.leased(self._cid)
            assert leaked == 0, (
                f"Comm.free left {leaked} registered shm slot lease(s) on "
                f"cid {self._cid} — a PlanRegistration escaped the registry")

    def py2f(self) -> int:
        return self._cid

    def __repr__(self) -> str:
        return f"<Comm {self.name} cid={self._cid} size={len(self._group)}>"


class _WorldComm(Comm):
    """COMM_WORLD: the calling rank's *job world*, resolved dynamically so the
    module-level constant works on every rank-thread (src/comm.jl:13-17).
    Ranks created by Comm_spawn form their own world, exactly as spawned MPI
    jobs get their own MPI_COMM_WORLD."""

    def __init__(self):
        super().__init__((), 0, name="COMM_WORLD")

    @property
    def group(self) -> tuple[int, ...]:
        ctx, world_rank = require_env()
        return ctx.world_of(world_rank)[0]

    @property
    def cid(self):
        ctx, world_rank = require_env()
        return ctx.world_of(world_rank)[1]

    def rank(self) -> int:
        ctx, world_rank = require_env()
        return ctx.world_of(world_rank)[0].index(world_rank)

    def size(self) -> int:
        ctx, world_rank = require_env()
        return len(ctx.world_of(world_rank)[0])

    def world_rank_of(self, comm_rank: int) -> int:
        ctx, world_rank = require_env()
        return ctx.world_of(world_rank)[0][comm_rank]

    def channel(self) -> CollectiveChannel:
        ctx, world_rank = require_env()
        group, cid = ctx.world_of(world_rank)
        return ctx.channel(cid, len(group), group=group)


class _SelfComm(Comm):
    """COMM_SELF: just the calling rank (src/comm.jl:19-23)."""

    def __init__(self):
        super().__init__((), 1, name="COMM_SELF")

    @property
    def group(self) -> tuple[int, ...]:
        _, world_rank = require_env()
        return (world_rank,)

    def rank(self) -> int:
        return 0

    def size(self) -> int:
        return 1

    def world_rank_of(self, comm_rank: int) -> int:
        _, world_rank = require_env()
        return world_rank

    def channel(self) -> CollectiveChannel:
        ctx, world_rank = require_env()
        # Per-rank channel: cid 1 is logically distinct per rank; key it so.
        return ctx.channel((1, world_rank), 1, group=(world_rank,))


class _NullComm(Comm):
    """COMM_NULL sentinel (src/comm.jl:8-11)."""

    def __init__(self):
        super().__init__((), -1, name="COMM_NULL")

    def rank(self) -> int:
        raise InvalidCommError("Comm_rank on COMM_NULL")

    def size(self) -> int:
        raise InvalidCommError("Comm_size on COMM_NULL")

    def channel(self):
        raise InvalidCommError("collective on COMM_NULL")


COMM_WORLD = _WorldComm()
COMM_SELF = _SelfComm()
COMM_NULL = _NullComm()


def Comm_rank(comm: Comm) -> int:
    """Rank of the calling process in comm (src/comm.jl:49-53)."""
    return comm.rank()


def Comm_size(comm: Comm) -> int:
    """Number of ranks in comm (src/comm.jl:66-70)."""
    return comm.size()


def _record_coll(comm: Comm, opname: str) -> None:
    """Trace hook for the comm-management collectives, which rendezvous
    directly on the channel rather than through collective._run."""
    from .analyze import events as _ev
    if _ev.enabled():
        _ev.record_collective(comm, opname)


def Comm_dup(comm: Comm) -> Comm:
    """Collective: duplicate comm with a fresh context id (src/comm.jl:78-84)."""
    _record_coll(comm, f"Comm_dup@{comm.cid}")
    my_rank = comm.rank()
    group = comm.group

    def combine(contribs):
        ctx = comm.ctx
        cid = ctx.alloc_cid()
        return [cid] * len(contribs)

    cid = comm.channel().run(my_rank, None, combine, f"Comm_dup@{comm.cid}")
    return Comm(group, cid, name=f"{comm.name}.dup")


def Comm_split(comm: Comm, color: Optional[int], key: int) -> Comm:
    """Collective: partition ranks by color, order by (key, rank)
    (src/comm.jl:92-99). ``color=None`` (UNDEFINED) returns COMM_NULL."""
    _record_coll(comm, f"Comm_split@{comm.cid}")
    my_rank = comm.rank()
    group = comm.group
    c = UNDEFINED if color is None else int(color)

    def combine(contribs):
        ctx = comm.ctx
        colors: dict[int, list[tuple[int, int]]] = {}
        for r, (col, k) in enumerate(contribs):
            if col != UNDEFINED:
                colors.setdefault(col, []).append((k, r))
        new_comms: dict[int, tuple[tuple[int, ...], int]] = {}
        for col in sorted(colors):
            members = [r for (_, r) in sorted(colors[col])]
            new_group = tuple(group[r] for r in members)
            new_comms[col] = (new_group, ctx.alloc_cid())
        out = []
        for r, (col, _) in enumerate(contribs):
            out.append(None if col == UNDEFINED else new_comms[col])
        return out

    res = comm.channel().run(my_rank, (c, int(key)), combine, f"Comm_split@{comm.cid}")
    if res is None:
        return COMM_NULL
    new_group, cid = res
    return Comm(new_group, cid, name=f"{comm.name}.split({c})")


def Comm_split_type(comm: Comm, split_type: int, key: int) -> Comm:
    """Split into groups that can share memory (src/comm.jl:107-115).

    Each rank contributes its backend ``host_token`` (thread tier: one
    address space, one token; multi-process tier: the rank's transport
    address host, or the TPU_MPI_HOST_ID override) to a rendezvous, and the
    color is the lowest comm rank holding the same token — so a multi-host
    ``--procs`` world splits into genuine per-host groups instead of one
    bogus world-wide "shared" group."""
    if split_type != COMM_TYPE_SHARED:
        return Comm_split(comm, None, key)

    def combine(tokens):
        first = {}
        for r, tok in enumerate(tokens):
            first.setdefault(tok, r)
        return [first[tok] for tok in tokens]

    color = comm.channel().run(comm.rank(), comm.ctx.host_token, combine,
                               f"Comm_split_type@{comm.cid}")
    return Comm_split(comm, color, key)


# ---------------------------------------------------------------------------
# ULFM-shaped fault tolerance: Comm_revoke / Comm_agree / Comm_shrink
# (MPI 4.x User-Level Failure Mitigation surface; docs/fault-tolerance.md)
# ---------------------------------------------------------------------------

def _next_epoch(ctx, cid, world_rank) -> int:
    """Per-communicator agreement epoch: this rank's own call count.
    Comm_agree/Comm_shrink are collective, so every member advances its
    counter in lockstep and the epochs align without communication. Keyed by
    (cid, rank) — in the thread tier ``ctx`` is SHARED by all rank threads,
    and a shared per-cid counter would interleave."""
    seq = getattr(ctx, "_agree_seq", None)
    if seq is None:
        seq = ctx._agree_seq = {}
    e = seq.get((cid, world_rank), 0) + 1
    seq[(cid, world_rank)] = e
    return e


def Comm_revoke(comm: Comm) -> None:
    """Revoke the communicator after a failure (MPI_Comm_revoke analog).

    Non-collective: any member may call it. Every pending and future
    operation on the communicator — on every member that learns of the
    revocation — raises :class:`~tpu_mpi_torch.error.RevokedError` instead of
    hanging on a dead peer. Only Comm_agree and Comm_shrink remain legal.
    Multi-process tier: a revoke frame is flooded to the group and each
    receiver re-floods once, so propagation completes even if the original
    caller dies mid-flood."""
    comm._check()
    ctx = comm.ctx
    _record_coll(comm, f"Comm_revoke@{comm.cid}")
    from .analyze import events as _ev
    if _ev.enabled():
        _ev.record_ft(comm, "Comm_revoke")
    ctx.revoke_comm(comm.cid)
    flood = getattr(ctx, "flood", None)
    if flood is not None:
        flood(comm.group, ("revoke", comm.cid, tuple(comm.group)))


def Comm_agree(comm: Comm, flag: int = 1) -> int:
    """Fault-tolerant agreement (MPI_Comm_agree analog): returns the bitwise
    AND of every live member's ``flag``. Works on a revoked communicator and
    completes despite concurrent member failures — the recovery path's
    decision primitive ("did everyone succeed / shall we shrink?")."""
    comm._check()
    ctx, world_rank = require_env()
    _record_coll(comm, f"Comm_agree@{comm.cid}")
    epoch = _next_epoch(ctx, comm.cid, world_rank)
    value, dead = ctx.ft_agree(world_rank, comm.group, comm.cid, epoch,
                               int(flag))
    from .analyze import events as _ev
    if _ev.enabled():
        # T207 front end: every member must report the same epoch/value/dead
        # view for this agreement, or the recovery protocol has diverged
        _ev.record_ft(comm, "Comm_agree", epoch=epoch, dead=dead, value=value)
    return value


def Comm_shrink(comm: Comm) -> Comm:
    """Build the survivor communicator (MPI_Comm_shrink analog).

    Collective over the LIVE members: agrees on the union of everyone's
    failed-rank views, then forms a new communicator of the survivors in
    group order. The new context id is derived deterministically from the
    agreement — ``("shrink", old_cid, epoch)`` — so no rendezvous through a
    (possibly dead) root is needed. Dead-rank state tied to the old
    communicator (collective channel, cached overlap plans) is drained
    before the replacement goes live."""
    comm._check()
    ctx, world_rank = require_env()
    _record_coll(comm, f"Comm_shrink@{comm.cid}")
    epoch = _next_epoch(ctx, comm.cid, world_rank)
    _value, dead = ctx.ft_agree(world_rank, comm.group, comm.cid, epoch, 1)
    survivors = tuple(r for r in comm.group if r not in dead)
    from .analyze import events as _ev
    if _ev.enabled():
        _ev.record_ft(comm, "Comm_shrink", epoch=epoch, survivors=survivors,
                      dead=dead)
    drain = getattr(ctx, "drain_failed_state", None)
    if drain is not None:
        drain(comm.cid)
    if world_rank not in survivors:
        return COMM_NULL
    if not dead:
        # nothing failed (e.g. the thread tier, where ranks share a
        # process): still a fresh communicator, via the ordinary collective
        # cid allocation — the channel combine runs alloc_cid once
        new_cid = ctx.channel(("ftshrink", comm.cid, epoch), len(survivors),
                              survivors).run(
            survivors.index(world_rank), None,
            lambda contribs: [ctx.alloc_cid()] * len(contribs),
            f"Comm_shrink@{comm.cid}")
    else:
        new_cid = ("shrink", comm.cid, epoch)
    # register the survivor channel EAGERLY with its group: check_fault
    # consults the channel's group to scope failures, which is what lets a
    # shrunk communicator keep operating while failed_ranks stays non-empty
    ctx.channel(new_cid, len(survivors), survivors)
    return Comm(survivors, new_cid, name=f"{comm.name}.shrink")


class Intercomm(Comm):
    """An inter-communicator: a local group plus a remote group sharing one
    context (src/comm.jl:135-162). Point-to-point ranks address the *remote*
    group, per MPI intercomm semantics; Comm_rank/Comm_size are local."""

    def __init__(self, local_group: Sequence[int], remote_group: Sequence[int],
                 cid: int, name: str = "intercomm"):
        super().__init__(local_group, cid, name=name)
        self.remote_group = tuple(remote_group)

    def remote_size(self) -> int:
        return len(self.remote_group)

    def world_rank_of(self, comm_rank: int) -> int:
        # dest/src in P2P over an intercomm are remote-group ranks.
        return self.remote_group[comm_rank]

    def channel(self) -> CollectiveChannel:
        # Intercomm collectives have two-group semantics the intracomm
        # rendezvous cannot express (both sides would deposit into overlapping
        # local-rank slots of one cid-keyed channel). Barrier/Bcast/bcast use
        # the two-group channel with MPI_ROOT semantics (collective.py); for
        # the rest, Intercomm_merge into an intracommunicator first.
        raise MPIError("only Barrier/Bcast/bcast are supported on an "
                       "intercommunicator; Intercomm_merge it into an "
                       "intracommunicator for other collectives",
                       code=_ec.ERR_COMM)

    def two_group_slots(self) -> tuple[tuple[int, ...], tuple[int, ...], int]:
        """Canonical rendezvous ordering across both groups (shared with
        Intercomm_merge): the group containing the smaller world rank is "A"
        and occupies slots [0, len(A)); returns (A, B, my slot)."""
        local, remote = self.group, self.remote_group
        a, b = (local, remote) if min(local) < min(remote) else (remote, local)
        _, world_rank = require_env()
        slot = (a.index(world_rank) if world_rank in a
                else len(a) + b.index(world_rank))
        return tuple(a), tuple(b), slot

    def two_group_channel(self):
        """The all-ranks-of-both-groups rendezvous used by intercomm
        collectives (MPI_ROOT semantics; MPI.jl src/comm.jl:135-162
        creates intercomms whose collectives libmpi honors). Returns
        (channel, my_slot, A, B)."""
        self._check()
        a, b, slot = self.two_group_slots()
        chan = self.ctx.channel(("inter", self.cid), len(a) + len(b),
                                group=a + b)
        return chan, slot, a, b

    def __repr__(self) -> str:
        return (f"<Intercomm {self.name} cid={self.cid} local={len(self.group)} "
                f"remote={len(self.remote_group)}>")


def spawn_argv() -> list:
    """The argv a spawned worker was launched with (empty outside a spawned
    rank). Spawned scripts read this instead of sys.argv — workers are threads
    of one process, so mutating the global sys.argv would race."""
    ctx, world_rank = require_env()
    return list(ctx.spawn_argv.get(world_rank, []))


def _worker_argv(command, argv) -> list:
    """The argv the spawned worker should see: the full list, minus the script
    entry when (and only when) the script was resolved *from* argv because
    ``command`` itself wasn't runnable (mirrors _run_spawned's resolution)."""
    argv = [str(a) for a in (argv or [])]
    if callable(command) or (isinstance(command, str) and command.endswith(".py")):
        return argv
    scripts = [a for a in argv if a.endswith(".py")]
    if scripts:
        argv = list(argv)
        argv.remove(scripts[0])
    return argv


def _run_spawned(command, argv):
    """Execute a spawned worker: a Python callable, or a .py script path
    (the analog of `mpiexec`-ing `julia spawned_worker.jl`,
    test/spawned_worker.jl:6-8). Script workers get their args via
    :func:`spawn_argv`, never via the (process-global) sys.argv."""
    if callable(command):
        command(*(argv or ()))
        return
    import runpy
    if isinstance(command, str) and command.endswith(".py"):
        script = command
    elif argv:
        scripts = [a for a in argv if str(a).endswith(".py")]
        if not scripts:
            raise MPIError(f"cannot spawn {command!r}: no python script in argv",
                           code=_ec.ERR_SPAWN)
        script = scripts[0]
    else:
        raise MPIError(f"cannot spawn {command!r}: pass a callable or a .py path",
                       code=_ec.ERR_SPAWN)
    runpy.run_path(script, run_name="__main__")


def Comm_spawn(command, argv=None, maxprocs: int = 1, comm: Comm = COMM_WORLD,
               errors=None, **info) -> Intercomm:
    """Collectively spawn ``maxprocs`` new ranks running ``command`` (a Python
    callable or script path), returning the parent side of an intercomm
    (src/comm.jl:135-147).

    OS-process spawn has no ICI analog (SURVEY.md §2.2): new ranks join the
    same controller process as fresh rank-threads with their own COMM_WORLD,
    the host-level emulation the survey prescribes."""
    _record_coll(comm, f"Comm_spawn@{comm.cid}")
    my_rank = comm.rank()
    parent_group = comm.group
    ctx = comm.ctx
    worker_argv = _worker_argv(command, argv)

    # A comparable identity for `command`: ranks disagreeing on
    # WHAT to spawn must be detected, not resolved by whichever rank's
    # closure runs the combine. Callables compare by qualified name + module.
    if callable(command):
        command_id = (getattr(command, "__module__", ""),
                      getattr(command, "__qualname__", repr(command)))
    else:
        command_id = str(command)
    contrib = (int(maxprocs), command_id, tuple(worker_argv))

    if hasattr(ctx, "spawn_processes"):
        # Multi-process tier: the star-root process launches real child OS
        # processes that join the transport mesh (the honest analog of
        # libmpi spawning via the process manager, src/comm.jl:135-147);
        # every parent then grows its world view.
        def combine_procs(cs):
            if any(c != cs[0] for c in cs[1:]):
                from .error import CollectiveMismatchError
                raise CollectiveMismatchError(
                    f"Comm_spawn arguments disagree across ranks: {cs!r}")
            return [ctx.spawn_processes(int(maxprocs), command, argv,
                                        parent_group)] * len(cs)

        child_group, inter_cid, _world_cid, world_addrs = comm.channel().run(
            my_rank, contrib, combine_procs, f"Comm_spawn@{comm.cid}")
        ctx.apply_growth(world_addrs)
        if errors is not None:
            errors[:] = [0] * int(maxprocs)
        return Intercomm(parent_group, tuple(child_group), inter_cid,
                         name="spawn_intercomm")

    def combine(cs):
        # Spawn is collective: every parent rank must agree on what to spawn
        # (libmpi validates root-side args; here all ranks contribute, so
        # disagreement must fail loudly, not be resolved by arrival order).
        if any(c != cs[0] for c in cs[1:]):
            from .error import CollectiveMismatchError
            # no sorted(): contribs may be heterogeneous (str vs tuple
            # command ids) and must still produce THIS error, not TypeError
            raise CollectiveMismatchError(
                f"Comm_spawn arguments disagree across ranks: {cs!r}")
        world_cid = ctx.alloc_cid()
        inter_cid = ctx.alloc_cid()
        child_group = ctx.add_ranks(int(maxprocs), world_cid)
        for r in child_group:
            # Each child gets its own handle: freeing one must not invalidate
            # a sibling's (MPI handles are per-process).
            ctx.parent_comm[r] = Intercomm(child_group, parent_group, inter_cid,
                                           name="parent_intercomm")
            ctx.spawn_argv[r] = list(worker_argv)
            ctx.start_rank_thread(r, lambda: _run_spawned(command, argv))
        return [(child_group, inter_cid)] * len(cs)

    child_group, inter_cid = comm.channel().run(
        my_rank, contrib, combine, f"Comm_spawn@{comm.cid}")
    if errors is not None:
        errors[:] = [0] * int(maxprocs)
    return Intercomm(parent_group, child_group, inter_cid, name="spawn_intercomm")


def Comm_get_parent() -> Comm:
    """The intercomm to the spawning job, or COMM_NULL (src/comm.jl:123-127)."""
    ctx, world_rank = require_env()
    return ctx.parent_comm.get(world_rank, COMM_NULL)


def _epoch_view(ctx, world_rank) -> dict:
    """This rank's agreement-epoch state, per communicator: the slice of
    ``ctx._agree_seq`` keyed by ``world_rank``. Contributed to
    Intercomm_merge so ranks joining an older (possibly shrunk) world can
    adopt its epoch space instead of silently diverging from it."""
    seq = getattr(ctx, "_agree_seq", None) or {}
    return {cid: e for (cid, r), e in seq.items() if r == world_rank}


def Intercomm_merge(intercomm: Intercomm, high: bool) -> Comm:
    """Collectively merge an intercomm's two groups into one intracomm
    (src/comm.jl:155-162). Groups whose members pass ``high=False`` are
    ordered first.

    Merging into a *shrunk* world is supported: every rank contributes its
    per-communicator agreement-epoch view, established members must agree
    on theirs (a divergence is a loud ``MPIError``, never a silently forked
    cid space), and joining ranks adopt the agreed epochs — so a later
    ``Comm_agree``/``Comm_shrink`` on a pre-existing communicator derives
    the same epoch (and thus the same shrink cid) on old and new ranks
    alike. The merged channel is registered eagerly so the new comm is
    usable while ``failed_ranks`` is non-empty (same contract as
    ``Comm_shrink``)."""
    if not isinstance(intercomm, Intercomm):
        raise MPIError("Intercomm_merge requires an intercommunicator",
                       code=_ec.ERR_COMM)
    _record_coll(intercomm, f"Intercomm_merge@{intercomm.cid}")
    ctx = intercomm.ctx
    a, b, slot = intercomm.two_group_slots()
    _, world_rank = require_env()
    total = len(a) + len(b)
    chan = ctx.channel(("merge", intercomm.cid), total, group=a + b)

    def combine(cs):
        cid = ctx.alloc_cid()
        lows = [(s, wr) for s, (wr, hi, _v) in enumerate(cs) if not hi]
        highs = [(s, wr) for s, (wr, hi, _v) in enumerate(cs) if hi]
        merged = tuple(wr for _, wr in lows) + tuple(wr for _, wr in highs)
        views: dict = {}
        for wr, _hi, view in cs:
            for vcid, e in view.items():
                views.setdefault(vcid, {})[wr] = e
        adopt = {}
        for vcid, per in views.items():
            if len(set(per.values())) > 1:
                raise MPIError(
                    f"Intercomm_merge: agreement-epoch mismatch on comm "
                    f"{vcid}: " + ", ".join(
                        f"world rank {r} at epoch {e}"
                        for r, e in sorted(per.items(), key=lambda kv:
                                           str(kv[0]))) +
                    " — the merging groups ran divergent agree/shrink "
                    "histories and would fork the shrink-cid space",
                    code=_ec.ERR_SPAWN)
            adopt[vcid] = next(iter(per.values()))
        return [(merged, cid, adopt)] * total

    merged, cid, adopt = chan.run(
        slot, (world_rank, bool(high), _epoch_view(ctx, world_rank)),
        combine, f"Intercomm_merge@{intercomm.cid}")
    seq = getattr(ctx, "_agree_seq", None)
    if seq is None:
        seq = ctx._agree_seq = {}
    for vcid, e in adopt.items():
        for wr in merged:
            seq.setdefault((vcid, wr), e)
    ctx.channel(cid, len(merged), tuple(merged))
    return Comm(merged, cid, name="merged")


def Comm_compare(comm1: Comm, comm2: Comm) -> Comparison:
    """Compare two communicators (src/comm.jl:197-218).

    IDENT: same context; CONGRUENT: same members, same order; SIMILAR: same
    members, different order; UNEQUAL otherwise.
    """
    if comm1 is comm2 or comm1.cid == comm2.cid:
        return Comparison.IDENT
    g1, g2 = comm1.group, comm2.group
    if g1 == g2:
        return Comparison.CONGRUENT
    if sorted(g1) == sorted(g2):
        return Comparison.SIMILAR
    return Comparison.UNEQUAL


def free(obj) -> None:
    """Release a communicator/window/datatype (src/handle.jl:50, src/comm.jl).

    No C resources back these objects; freeing marks them unusable (and a
    communicator's free() also reclaims its I-collective worker thread)."""
    if isinstance(obj, (_WorldComm, _SelfComm, _NullComm)):
        raise MPIError("cannot free a builtin communicator", code=_ec.ERR_COMM)
    if hasattr(obj, "free"):
        obj.free()
    elif hasattr(obj, "_freed"):
        obj._freed = True
