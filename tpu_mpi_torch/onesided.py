"""One-sided RMA: windows, epochs, Put/Get/Accumulate atomics — the port
of ``tpu_mpi/onesided.py``'s thread tier.

Reference: /root/reference/src/onesided.jl — Win handle (:1), LockType
EXCLUSIVE/SHARED (:6-10), Win_create (:24-34), Win_create_dynamic (:47-56),
Win_allocate_shared + Win_shared_query (:72-107), Win_attach/Win_detach
(:109-121), Win_fence (:123-126), Win_flush (:128-131), Win_sync (:133-136),
Win_lock/Win_unlock (:138-148), Get (:150-166), Put (:168-184), Fetch_and_op
(:186-195), Accumulate (:197-206), Get_accumulate (:208-219).

Ranks are threads of one process, so a window exposes each rank's buffer
directly: Put and Get are copies of exactly the targeted range, on the
buffer's device (a CUDA window stays on the card). Epoch calls map to the
rendezvous barrier (fence) and to real reader/writer locks (passive
target); Accumulate/Fetch_and_op take a per-target mutex, giving the
element-wise atomicity MPI guarantees for accumulates.

Window memory by kind:

- a raw tensor is written in place, so it must be contiguous
  (:func:`Win_create` refuses another up front);
- a ``DeviceBuffer`` rebinds its cell on every write under the per-target
  mutex (cells copy on write: each write copies the whole cell);
- a numpy array is written in place, as in the JAX package.

Accumulate on a tensor window is the two-operand rank-ordered fold
``op(old, origin)`` of ``operators.acc_combine``: one launch of the fused
fold kernel on a CUDA window for a predefined op it takes.

Target displacements follow MPI's disp_unit scaling: windows created over an
array use its element size as disp_unit (displacements are element offsets,
src/onesided.jl:30); dynamic windows use byte addresses obtained from
:func:`~tpu_mpi_torch.datatypes.Get_address` (test_onesided.jl:96-99).

On a comm whose ranks are OS processes (``tpurun-torch --procs``) every
entry point routes through the wire engine (``tpu_mpi_torch._rma_wire``):
owners apply Put/Get/Accumulate/lock frames shipped by origins, tensors
cross through the host, and shared windows are real POSIX shared memory
exposed as CPU tensors.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ._runtime import require_env, deadlock_timeout, raise_deadlock, _POLL
from .analyze import events as _ev
from . import perfvars as _pv
from .buffers import (DeviceBuffer, as_tensor, element_count, extract_array,
                      itemsize, resolve_attached, resolve_device, to_numpy,
                      write_flat, write_range)
from .comm import Comm
from .datatypes import Get_address, torch_dtype
from . import error as _ec
from .error import MPIError
from .operators import NO_OP, Op, acc_combine, as_op


class LockType:
    """Win_lock mode (src/onesided.jl:6-10)."""

    def __init__(self, val: int, name: str):
        self.val = val
        self.name = name

    def __repr__(self) -> str:
        return f"LOCK_{self.name}"


LOCK_EXCLUSIVE = LockType(1, "EXCLUSIVE")
LOCK_SHARED = LockType(2, "SHARED")


class _RWLock:
    """Reader/writer lock with failure-aware waits — the passive-target
    emulation (no device lock primitive is involved)."""

    def __init__(self):
        self.cond = threading.Condition()
        self.readers = 0
        self.writer = False

    def acquire(self, ctx, exclusive: bool) -> None:
        limit = deadlock_timeout()
        deadline = time.monotonic() + limit
        with self.cond:
            while self.writer or (exclusive and self.readers > 0):
                ctx.check_failure()
                if time.monotonic() > deadline:
                    raise_deadlock(ctx, "deadlock suspected: Win_lock blocked "
                                        f">{limit}s")
                self.cond.wait(_POLL)
            if exclusive:
                self.writer = True
            else:
                self.readers += 1

    def release(self, exclusive: bool) -> None:
        with self.cond:
            if exclusive:
                self.writer = False
            else:
                self.readers -= 1
            self.cond.notify_all()


class _WinState:
    """State shared by every rank's Win handle (created once per collective
    Win_create by the rendezvous combiner)."""

    def __init__(self, size: int, dynamic: bool = False):
        self.size = size
        self.dynamic = dynamic
        # rank -> (buffer, disp_unit); dynamic windows use attach lists.
        self.buffers: dict[int, tuple[Any, int]] = {}
        self.attached: dict[int, list[tuple[int, int, Any]]] = {r: [] for r in range(size)}
        self.user_locks = [_RWLock() for _ in range(size)]     # Win_lock/unlock
        self.atomic_locks = [threading.Lock() for _ in range(size)]  # accumulates
        self.freed = False
        self._free_count = 0
        self._free_lock = threading.Lock()


class Win:
    """RMA window handle (src/onesided.jl:1-4)."""

    def __init__(self, state: _WinState, comm: Comm):
        self._state = state
        self.comm = comm
        self._held: list[tuple[int, bool]] = []   # (target, exclusive) lock stack

    def _check(self) -> None:
        if self._state.freed:
            raise MPIError("window has been freed", code=_ec.ERR_WIN)

    def free(self) -> None:
        """Release the window. MPI_Win_free is collective (src/onesided.jl:
        85-92): the shared state is only invalidated once every rank of the
        communicator has called free, so stragglers can still detach."""
        st = self._state
        if getattr(st, "is_proc", False):
            from ._rma_wire import proc_free
            proc_free(self)
            return
        with st._free_lock:
            st._free_count += 1
            if st._free_count >= st.size:
                st.freed = True

    def __repr__(self) -> str:
        kind = "dynamic" if self._state.dynamic else "static"
        return f"<Win {kind} over comm of size {self._state.size}>"


def _is_proc_mode(comm: Comm) -> bool:
    """Multi-process worlds route RMA through the wire engine
    (tpu_mpi_torch._rma_wire): owners apply frames, shared memory is real
    POSIX shm — the reference's windows likewise span OS processes via
    libmpi."""
    return not getattr(comm.ctx, "supports_shared_objects", True)


def _collective_state(comm: Comm, contrib, opname: str) -> Any:
    """One rendezvous that makes the last arriver build shared state."""
    if _ev.enabled():
        _ev.record_collective(comm, opname)

    def combine(cs):
        st = _WinState(len(cs), dynamic=all(c is None for c in cs))
        for r, c in enumerate(cs):
            if c is not None:
                st.buffers[r] = c
        return [st] * len(cs)

    return comm.channel().run(comm.rank(), contrib, combine, opname)


def Win_create(base: Any, comm: Comm, **infokws) -> Win:
    """Collectively create a window over each rank's ``base`` array
    (src/onesided.jl:24-34). disp_unit = element size, so displacements in
    Put/Get/accumulates are element offsets into the target's array. A raw
    tensor is written in place and must be contiguous."""
    arr = extract_array(base)
    if arr is None:
        raise MPIError(f"not a window buffer: {type(base).__name__}",
                       code=_ec.ERR_WIN)
    if isinstance(base, torch.Tensor) and not base.is_contiguous():
        raise MPIError("a window over a raw tensor is written in place and "
                       "needs it contiguous", code=_ec.ERR_WIN)
    if _is_proc_mode(comm):
        from ._rma_wire import create_proc_window
        st = create_proc_window(comm, base, itemsize(arr),
                                f"Win_create@{comm.cid}")
        return Win(st, comm)
    st = _collective_state(comm, (base, itemsize(arr)), f"Win_create@{comm.cid}")
    return Win(st, comm)


def Win_create_dynamic(comm: Comm, **infokws) -> Win:
    """Collectively create a window with no initial memory
    (src/onesided.jl:47-56); use :func:`Win_attach` to expose buffers."""
    if _is_proc_mode(comm):
        from ._rma_wire import create_proc_window
        st = create_proc_window(comm, None, None,
                                f"Win_create_dynamic@{comm.cid}", dynamic=True)
        return Win(st, comm)
    st = _collective_state(comm, None, f"Win_create_dynamic@{comm.cid}")
    st.dynamic = True
    return Win(st, comm)


def Win_allocate_shared(T: Any, length: int, comm: Comm, device: Any = None,
                        **infokws):
    """Allocate ``length`` elements of node-shared memory per rank
    (src/onesided.jl:72-83). Returns ``(win, tensor)``: a zeroed tensor on
    ``device``, ``cuda`` unless the caller asks for another (as
    ``DeviceBuffer(..., device=)`` takes it). Peers reach another rank's
    slab via :func:`Win_shared_query`; ranks share one address space, so
    the owner's tensor *is* the shared block.

    Across OS processes the slab is POSIX shared memory, so the window is a
    CPU tensor over it and ``device="cpu"`` must be asked for: a CUDA slab
    shared by the processes on one card would need CUDA IPC, which this
    tier does not use."""
    if _is_proc_mode(comm):
        if torch.device("cuda" if device is None else device).type != "cpu":
            raise MPIError(
                "Win_allocate_shared across processes allocates host shared "
                "memory; pass device=\"cpu\"", code=_ec.ERR_WIN)

        # POSIX shm only reaches ranks on this machine: refuse a comm that
        # spans hosts instead of handing peers segment names they cannot
        # map. The caller should split with Comm_split_type
        # (COMM_TYPE_SHARED) first, per MPI semantics (src/onesided.jl:72-83
        # requires a shared-memory comm).
        def combine(tokens):
            return [sorted(set(tokens))] * len(tokens)

        tokens = comm.channel().run(comm.rank(), comm.ctx.host_token, combine,
                                    f"Win_allocate_shared/hosts@{comm.cid}")
        if len(tokens) > 1:
            raise MPIError(
                f"Win_allocate_shared requires all ranks on one host, but the "
                f"communicator spans {len(tokens)} hosts {tokens}; split it "
                f"with Comm_split_type(comm, COMM_TYPE_SHARED, rank) first")
        from ._rma_wire import create_proc_shared
        st, local = create_proc_shared(comm, torch_dtype(T), int(length),
                                       f"Win_allocate_shared@{comm.cid}")
        return Win(st, comm), local
    local = torch.zeros(int(length), dtype=torch_dtype(T),
                        device=resolve_device(device))
    st = _collective_state(comm, (local, local.element_size()),
                           f"Win_allocate_shared@{comm.cid}")
    return Win(st, comm), local


def Win_shared_query(win: Win, owner_rank: int):
    """(size_bytes, disp_unit, buffer) of a peer's shared slab
    (src/onesided.jl:97-107). The buffer is the live shared tensor — the
    pointer-free analog of the reference's baseptr."""
    win._check()
    if getattr(win._state, "is_proc", False):
        from ._rma_wire import proc_shared_query
        return proc_shared_query(win._state, owner_rank)
    entry = win._state.buffers.get(int(owner_rank))
    if entry is None:
        raise MPIError(f"rank {owner_rank} exposes no memory in this window",
                       code=_ec.ERR_WIN)
    buf, disp_unit = entry
    arr = extract_array(buf)
    return element_count(arr) * itemsize(arr), disp_unit, buf


def Win_attach(win: Win, base: Any) -> None:
    """Expose a buffer through a dynamic window (src/onesided.jl:109-114).
    Targets address it by its :func:`Get_address` byte address, taken
    here: a ``DeviceBuffer`` rebound by a later write keeps resolving."""
    win._check()
    if not win._state.dynamic:
        raise MPIError("Win_attach requires a dynamic window", code=_ec.ERR_WIN)
    if isinstance(base, torch.Tensor) and not base.is_contiguous():
        raise MPIError("an attached raw tensor is written in place and "
                       "needs it contiguous", code=_ec.ERR_WIN)
    arr = extract_array(base)
    entry = (Get_address(arr), element_count(arr) * itemsize(arr), base)
    if getattr(win._state, "is_proc", False):
        win._state.attached.append(entry)      # local list; owner resolves
        return
    win._state.attached[win.comm.rank()].append(entry)


def Win_detach(win: Win, base: Any) -> None:
    """Remove an attached buffer (src/onesided.jl:116-121)."""
    win._check()
    if getattr(win._state, "is_proc", False):
        lst = win._state.attached
    else:
        lst = win._state.attached[win.comm.rank()]
    for i, (_, _, b) in enumerate(lst):
        if b is base:
            del lst[i]
            return
    raise MPIError("buffer was not attached to this window", code=_ec.ERR_WIN)


# ---------------------------------------------------------------------------
# Epochs
# ---------------------------------------------------------------------------

def Win_fence(assert_: int, win: Win) -> None:
    """Collective epoch separator (src/onesided.jl:123-126): all RMA issued
    before the fence completes at every rank — a rendezvous barrier here,
    since Put/Get complete synchronously in shared memory; multi-process
    windows first flush every dirty target over the wire.

    On the card the barrier orders device work too, with no device
    synchronize: every rank thread launches on the device's default stream
    (ROADMAP Queue A #12), so a copy or fold issued before the fence runs
    before any issued after it. A rank that moves its RMA to another
    stream owns that ordering."""
    win._check()
    if _pv.enabled():
        _pv.note_rma(win.comm, "fence")
    traced = _ev.enabled()
    opname = f"Win_fence@{win.comm.cid}"
    if traced:
        _ev.record_collective(win.comm, opname)
        _ev.fence_begin(win)
    if getattr(win._state, "is_proc", False):
        from ._rma_wire import proc_fence
        proc_fence(win)
        if traced:
            _ev.fence_end(win)
        return
    if traced:
        bev = _ev.blocked_event(win.comm, "coll", opname)
        _ev.set_blocked(win.comm.ctx, bev)
        try:
            win.comm.channel().run(win.comm.rank(), None,
                                   lambda cs: [None] * len(cs), opname)
        finally:
            _ev.clear_blocked(win.comm.ctx, bev)
        _ev.fence_end(win)
        return
    win.comm.channel().run(win.comm.rank(), None, lambda cs: [None] * len(cs),
                           opname)


def Win_flush(rank: int, win: Win) -> None:
    """Complete outstanding RMA to ``rank`` (src/onesided.jl:128-131):
    synchronous in shared memory, ordered on the default stream;
    multi-process windows await the owner's FIFO ack, which completes every
    earlier op from this origin."""
    win._check()
    if _pv.enabled():
        _pv.note_rma(win.comm, "flush")
    if _ev.enabled():
        _ev.record_sync(win, "Win_flush")
    if getattr(win._state, "is_proc", False):
        from ._rma_wire import proc_flush
        proc_flush(win._state, rank)


def Win_sync(win: Win) -> None:
    """Memory barrier on the window (src/onesided.jl:133-136)."""
    win._check()


def Win_lock(lock_type: LockType, rank: int, assert_: int, win: Win) -> None:
    """Begin a passive-target epoch on ``rank``'s window copy
    (src/onesided.jl:138-143): EXCLUSIVE excludes all, SHARED excludes
    writers — a real reader/writer lock."""
    win._check()
    if _pv.enabled():
        _pv.note_rma(win.comm, "lock")
    ctx, _ = require_env()
    excl = lock_type is LOCK_EXCLUSIVE or lock_type.val == LOCK_EXCLUSIVE.val
    target_world = win.comm.world_rank_of(int(rank))
    traced = _ev.enabled()
    bev = None
    if traced:
        bev = _ev.blocked_event(win.comm, "lock", "Win_lock", peer=target_world)
        _ev.set_blocked(ctx, bev)
    try:
        if getattr(win._state, "is_proc", False):
            from ._rma_wire import proc_lock
            proc_lock(win._state, int(rank), excl)
        else:
            win._state.user_locks[int(rank)].acquire(ctx, excl)
    finally:
        if traced:
            _ev.clear_blocked(ctx, bev)
    if traced:
        _ev.lock_acquired(win, target_world, excl)
    win._held.append((int(rank), excl))


def Win_unlock(rank: int, win: Win) -> None:
    """End the passive-target epoch (src/onesided.jl:145-148)."""
    win._check()
    rank = int(rank)
    for i in range(len(win._held) - 1, -1, -1):
        if win._held[i][0] == rank:
            _, excl = win._held.pop(i)
            if _ev.enabled():
                _ev.lock_released(win, win.comm.world_rank_of(rank), excl)
            if getattr(win._state, "is_proc", False):
                from ._rma_wire import proc_unlock
                proc_unlock(win._state, rank, excl)
            else:
                win._state.user_locks[rank].release(excl)
            return
    raise MPIError(f"Win_unlock: no lock held on rank {rank}",
                   code=_ec.ERR_RMA_SYNC)


# ---------------------------------------------------------------------------
# Data movement
# ---------------------------------------------------------------------------

def _target_view(win: Win, target_rank: int, target_disp: int, count: int):
    """The flat element range [disp, disp+count) of the target's exposed
    memory. Static windows: disp in elements of the target buffer. Dynamic
    windows: disp is a global byte address into an attached buffer."""
    st = win._state
    target_rank = int(target_rank)
    if st.dynamic:
        return resolve_attached(st.attached[target_rank], target_disp,
                                target_rank)
    if target_rank not in st.buffers:
        raise MPIError(f"rank {target_rank} exposes no memory in this window",
                       code=_ec.ERR_WIN)
    buf, _ = st.buffers[target_rank]
    return buf, extract_array(buf), int(target_disp)


def _origin_flat(origin: Any, count: int):
    """The first ``count`` elements of an origin buffer, flat (a view
    where the buffer is contiguous)."""
    arr = extract_array(origin)
    if arr is None:
        raise MPIError(f"not an RMA origin buffer: {type(origin).__name__}",
                       code=_ec.ERR_BUFFER)
    if element_count(arr) < count:
        raise MPIError(f"RMA origin has {element_count(arr)} elements, "
                       f"count={count}", code=_ec.ERR_COUNT)
    return arr.reshape(-1)[:count]


def _like_target(tarr: Any, src: Any):
    """Origin elements converted to the target's element type, on the
    target's device (a tensor target) or on the host (a numpy target)."""
    if isinstance(tarr, torch.Tensor):
        return as_tensor(src, tarr.dtype, tarr.device)
    return np.asarray(to_numpy(src), dtype=tarr.dtype)


def _args(origin: Any, args: tuple, what: str):
    if len(args) == 2:
        target_rank, win = args
        return element_count(origin), target_rank, 0, win
    if len(args) == 4:
        return args
    raise TypeError(f"{what}(origin, [count, rank, disp,] win)")


def Get(origin: Any, *args) -> None:
    """``Get(origin, [count, target_rank, target_disp | target_rank], win)`` —
    read from the target's window into origin (src/onesided.jl:150-166).
    The target range is sliced where it lives; only those elements move."""
    count, target_rank, target_disp, win = _args(origin, args, "Get")
    count = int(count)
    win._check()
    if _ev.enabled():
        _ev.rma_access(win, "Get", win.comm.world_rank_of(int(target_rank)),
                       int(target_disp), int(target_disp) + count)
    if getattr(win._state, "is_proc", False):
        from ._rma_wire import rma_get
        rma_get(win._state, origin, count, target_rank, target_disp)
        return
    buf, tarr, off = _target_view(win, target_rank, target_disp, count)
    data = tarr.reshape(-1)[off:off + count]
    if isinstance(origin, DeviceBuffer) and isinstance(data, torch.Tensor):
        data = data.clone()   # the cell rebinds to a copy, never the window
    write_flat(origin, data, count)


def Put(origin: Any, *args) -> None:
    """``Put(origin, [count, target_rank, target_disp | target_rank], win)`` —
    write origin into the target's window (src/onesided.jl:168-184)."""
    count, target_rank, target_disp, win = _args(origin, args, "Put")
    count = int(count)
    win._check()
    if _ev.enabled():
        _ev.rma_access(win, "Put", win.comm.world_rank_of(int(target_rank)),
                       int(target_disp), int(target_disp) + count)
    if getattr(win._state, "is_proc", False):
        from ._rma_wire import rma_put
        rma_put(win._state, origin, count, target_rank, target_disp)
        return
    buf, tarr, off = _target_view(win, target_rank, target_disp, count)
    new = _like_target(tarr, _origin_flat(origin, count))
    if isinstance(buf, DeviceBuffer):
        # DeviceBuffer writes rebind the whole cell: concurrent Puts into
        # DISTINCT slots of one target (legal in a fence epoch) would lose
        # updates without serialization under the per-target mutex.
        with win._state.atomic_locks[int(target_rank)]:
            write_range(buf, off, new)
    else:
        write_range(buf, off, new)   # in-place writes to distinct slots


def _apply_op(win: Win, target_rank: int, target_disp: int, origin_flat,
              op: Op, fetch_into: Optional[Any] = None) -> None:
    """op-combine origin into the target range under the per-target atomic
    mutex; optionally snapshot the old values first (Get_accumulate). Only
    the target range is snapshotted; a tensor target folds in place (a
    ``DeviceBuffer`` into a copy of its cell, then rebinds)."""
    st = win._state
    if getattr(st, "is_proc", False):
        from ._rma_wire import rma_accumulate
        rma_accumulate(st, origin_flat, target_rank, target_disp, op,
                       fetch_into=fetch_into)
        return
    count = element_count(origin_flat)
    with st.atomic_locks[int(target_rank)]:
        buf, tarr, off = _target_view(win, target_rank, target_disp, count)
        if isinstance(tarr, torch.Tensor):
            flat = tarr.reshape(-1)
            old = None
            if fetch_into is not None:
                old = flat[off:off + count].clone()
                write_flat(fetch_into, old, count)
            if op is NO_OP:
                return
            cell = isinstance(buf, DeviceBuffer)
            if cell:
                flat = flat.clone()             # copy on write
            # with a fetch, the fold starts from the values fetched, which a
            # result overlapping the target range has overwritten since
            target = flat[off:off + count]
            acc_combine(target if old is None else old, origin_flat, op,
                        out=target)
            if cell:
                buf.value = flat.view(tarr.shape)
            return
        old = np.asarray(tarr).reshape(-1)[off:off + count].copy()
        if fetch_into is not None:
            write_flat(fetch_into, old, count)
        new = acc_combine(old, to_numpy(origin_flat), op)
        if new is not None:
            write_range(buf, off, new)


def Accumulate(origin: Any, count: int, target_rank: int, target_disp: int,
               op: Any, win: Win) -> None:
    """Atomically combine origin into the target range with op
    (src/onesided.jl:197-206)."""
    win._check()
    if _ev.enabled():
        _ev.rma_access(win, "Accumulate",
                       win.comm.world_rank_of(int(target_rank)),
                       int(target_disp), int(target_disp) + int(count))
    src = _origin_flat(origin, int(count))
    _apply_op(win, target_rank, target_disp, src, as_op(op))


def Get_accumulate(origin: Any, result: Any, count: int, target_rank: int,
                   target_disp: int, op: Any, win: Win) -> None:
    """Fetch the old target values into result, then combine origin with op
    (src/onesided.jl:208-219)."""
    win._check()
    if _ev.enabled():
        _ev.rma_access(win, "Get_accumulate",
                       win.comm.world_rank_of(int(target_rank)),
                       int(target_disp), int(target_disp) + int(count))
    src = _origin_flat(origin, int(count))
    _apply_op(win, target_rank, target_disp, src, as_op(op), fetch_into=result)


def Fetch_and_op(sourceval: Any, returnval: Any, target_rank: int,
                 target_disp: int, op: Any, win: Win) -> None:
    """Single-element atomic fetch-and-combine (src/onesided.jl:186-195)."""
    win._check()
    if _ev.enabled():
        _ev.rma_access(win, "Fetch_and_op",
                       win.comm.world_rank_of(int(target_rank)),
                       int(target_disp), int(target_disp) + 1)
    src = _origin_flat(sourceval, 1)
    _apply_op(win, target_rank, target_disp, src, as_op(op), fetch_into=returnval)
