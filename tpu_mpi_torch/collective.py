"""Collectives over a communicator's rendezvous channel (host path).

Reference: MPI.jl src/collective.jl — Barrier (:15-19), Bcast! (:29-42)
+ serialized bcast (:44-60), Scatter(!*) (:90-129), Scatterv(!*) (:156-196),
Gather(!*) (:230-275), Allgather(!*) (:295-335), Gatherv(!*) (:363-403),
Allgatherv(!*) (:424-461), Alltoall(!*) (:489-532), Alltoallv(!*) (:545-578),
Reduce(!*) (:605-666), Allreduce(!*) (:691-738), Scan(!*) (:760-808),
Exscan(!*) (:834-882). Each exists in mutating, allocating, IN_PLACE and
scalar-object flavors; ``*v`` displacements are exclusive prefix sums.
``Reduce_scatter`` is absent in v0.14.2 — added here natively since XLA has it
(SURVEY.md §2.3 note).

API convention (Julia ``!`` does not exist in Python): one name per collective;
the *arity and argument kinds* select the flavor exactly as the reference's
method table does — ``Allreduce(send, op, comm)`` allocates,
``Allreduce(send, recv, op, comm)`` mutates, ``Allreduce(IN_PLACE, buf, op,
comm)`` is in-place; the scatter/gather family also accepts ``None`` for the
insignificant buffer like the reference accepts ``nothing``.

This is the *semantic* path, running over the thread rendezvous with zero-copy
shared-memory data placement. On CUDA tensors the rank-ordered reduction fold
runs as one hand-written kernel (:mod:`tpu_mpi_torch.kernels.fused_reduce`),
the port of the Pallas ``fused_multi_reduce``; the in-graph tier of the JAX
package is a later slice of the port.
"""

from __future__ import annotations

import functools
import pickle
import threading

from . import serialization as _serialization
from collections import OrderedDict
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .buffers import (IN_PLACE, DeviceBuffer, _InPlace, as_tensor,
                      assert_minlength, clone_like, element_count,
                      extract_array, is_torch_tensor, to_numpy, to_wire,
                      wire_view, write_flat)
from .comm import Comm, Intercomm, ROOT
from ._runtime import PROC_NULL
from . import error as _ec
from . import perfvars as _pv
from . import tune_online as _tune_online
from .analyze import events as _ev
from .error import CollectiveMismatchError, MPIError
from .kernels import fused_reduce as _fused
from .operators import Op, as_op
from .overlap import (ChunkSchedule, CollectivePlan, PersistentCollRequest,
                      PlanRegistration, demote_fast_armed as _demote_fast_armed,
                      plans as _plans, progress_begin, progress_note,
                      registry as _registry)


def _run(comm: Comm, contrib: Any, combine, opname: str, plan=None,
         _sig=None, stamp=None) -> Any:
    # _ordered_run (defined with the nonblocking machinery below) keeps a
    # blocking collective from racing this rank's in-flight nonblocking
    # ones to the rendezvous: with outstanding work it runs through the
    # same single worker, preserving program order.
    # ``_sig`` is the trace verifier's precise cross-rank-checkable
    # signature (root/dtype/count) when the caller knows one. ``stamp`` is
    # the payload key the thread tier checks across ranks each round
    # (``_payload_key``; only for ops whose counts MPI requires to match).
    traced = _ev.enabled()
    # pvar op scope: channels drop phase spans into it; op_end stamps the
    # trace event and the per-comm counters. op_begin() returns None when an
    # outer owner (e.g. _reduce_family, capturing the copy-out phase too)
    # already opened one — then the owner finalizes, not us.
    sc = _pv.op_begin() if (traced or _pv.enabled()) else None
    try:
        if not traced:
            return _ordered_run(comm, lambda: comm.channel().run(
                comm.rank(), contrib, combine, opname, plan=plan,
                stamp=stamp))
        ev = _ev.record_collective(comm, opname, sig=_sig)
        if sc is not None:
            sc.ev = ev
        elif traced:
            outer = _pv.scope()
            if outer is not None and outer.ev is None:
                outer.ev = ev
        from ._runtime import require_env
        ctx, _ = require_env()
        bev = _ev.blocked_event(comm, "coll", opname)
        _ev.set_blocked(ctx, bev)
        try:
            return _ordered_run(comm, lambda: comm.channel().run(
                comm.rank(), contrib, combine, opname, plan=plan,
                stamp=stamp))
        finally:
            _ev.clear_blocked(ctx, bev)
    finally:
        if sc is not None:
            sig = _sig or {}
            # plan opnames carry the cid ("Allreduce@0") — strip for the key
            _pv.op_end(sc, comm, coll=opname.split("@", 1)[0].lower(),
                       algo=sig.get("algo"),
                       dtype=(str(sig["dtype"]) if sig.get("dtype") is not None
                              else None),
                       nbytes=_pv.payload_nbytes(contrib))


def _run_rooted(comm: Comm, root: int, contrib: Any, combine, opname: str,
                plan=None, _sig=None, stamp=None) -> Any:
    """Rendezvous for rooted collectives: every rank ships its claimed root
    inside its contribution, and divergent roots raise CollectiveMismatchError
    on all ranks instead of silently electing whoever arrives first (the
    Scatterv root-shipped-counts pattern, applied to the whole rooted family).
    ``combine(contribs, root)`` sees the validated root."""
    size = comm.size()
    if not isinstance(root, (int, np.integer)) or not (0 <= root < size):
        raise MPIError(f"invalid root {root!r} for a size-{size} communicator",
                       code=_ec.ERR_ROOT)
    root = int(root)

    def outer(cs):
        roots = sorted({r for r, _ in cs})
        if len(roots) > 1:
            raise CollectiveMismatchError(
                f"ranks disagree on the root of {opname}: {roots}")
        return combine([c for _, c in cs], roots[0])

    sig = dict(_sig or {})
    sig.setdefault("root", root)
    return _run(comm, (root, contrib), outer, opname, plan=plan, _sig=sig,
                stamp=stamp)


def _payload_key(sig: dict) -> tuple:
    """A reduction's payload key for the cross-rank round check: its count
    and its dtype by name (a numpy and a torch float32 are one dtype)."""
    return (sig["count"], sig["dtype"].removeprefix("torch."))


# Algorithm selections resolved this config generation, keyed on the full
# decision signature — one tune.select() (config read + table stat + table
# walk) per distinct collective shape instead of per call. Plans cache their
# selection too; this layer covers the plan-less collectives (Barrier,
# Bcast, the gather/scatter family).
_select_cache: "OrderedDict[Any, str]" = OrderedDict()
_SELECT_CAP = 512


def _coll_select(comm: Comm, coll: str, nbytes: Optional[int], *,
                 commutative: bool = False, elementwise: bool = False,
                 numeric: bool = True) -> str:
    """The collective-algorithm decision for one signature: ``tune.select``
    (force-override → measured tuning table → built-in heuristic) with this
    communicator's topology filled in (same-host shm eligibility from the
    rendezvous address table). The selection rides the plan to the
    multi-process tier and into the event IR (``sig["algo"]``); the thread
    tier shares one address space and always runs its in-process star, so
    there the recorded selection documents what the proc tier would do."""
    from . import backend as _backend
    from . import config as _config
    from . import topology as _topo
    from . import tune
    ctx = getattr(comm, "ctx", None)
    shm = False
    chk = getattr(ctx, "coll_shm_ok", None)
    if chk is not None:
        shm = bool(chk(comm.group))
    # hierarchy-usable domain count: rank-uniform (a function of the
    # member list, config.domains and the replicated address table), so
    # every rank of the communicator selects the same tier
    dom = _topo.domain_count(ctx, comm.group)
    # _RING_MIN_BYTES is a live module knob (tests move it mid-run to force
    # or suppress the bulk tiers) — key on it so the memo can't pin a
    # selection across a threshold change
    key = (comm.cid, coll, nbytes, commutative, elementwise, numeric, shm,
           dom, _config.GENERATION, _backend._RING_MIN_BYTES)
    algo = _select_cache.get(key)
    if algo is None:
        algo = tune.select(coll, comm.size(), nbytes, commutative=commutative,
                           elementwise=elementwise, shm=shm, numeric=numeric,
                           domains=dom)
        _select_cache[key] = algo
        while len(_select_cache) > _SELECT_CAP:
            _select_cache.popitem(last=False)
    return algo


def _maybe_explore(comm: Comm, coll: str, nbytes: Optional[int], algo: str, *,
                   commutative: bool = False, elementwise: bool = False,
                   numeric: bool = True) -> str:
    """Online-autotuner hook at the decision point (docs/performance.md
    "Online tuning"): with exploration off — the default — this costs one
    generation-cached tuple compare; with it on, the bandit may reroute
    this call to an eligible alternate arm on its deterministic lockstep
    schedule. Called exactly once per user-facing collective call (never
    from plan build or registration), so the shared counters advance
    identically on every rank."""
    st = _tune_online.state()
    if st is None:
        return algo
    from . import topology as _topo
    ctx = getattr(comm, "ctx", None)
    chk = getattr(ctx, "coll_shm_ok", None)
    shm = bool(chk(comm.group)) if chk is not None else False
    dom = _topo.domain_count(ctx, comm.group)
    return st.decide(comm, coll, nbytes, algo, commutative=commutative,
                     elementwise=elementwise, numeric=numeric, shm=shm,
                     domains=dom)


def _wire_nbytes(payload: Any) -> Optional[int]:
    """Payload size for the algorithm decision: bytes when the wire payload
    is a fixed-dtype array, None (size unknown / object payload) otherwise.
    Must be rank-uniform — callers only pass buffers whose count and dtype
    the MPI contract replicates."""
    dt = getattr(payload, "dtype", None)
    if dt is None or dt == object:
        return None
    return int(getattr(payload, "nbytes", 0))


# Folds of tensors that could not enter the kernel and ran as the chained
# PyTorch fold instead (custom callables, ops or dtypes the kernel does not
# take, ragged operands, the fused_fold knob off). The main path keeps it
# still; a moving count names a fold that left the kernel.
chained_folds = 0
_chained_lock = threading.Lock()


def _kernel_op(op: Op, dtype: torch.dtype) -> Optional[str]:
    """The fused fold kernel's op name for ``op`` on ``dtype``, or None.
    A Python callable cannot enter a CUDA kernel, so only the predefined
    ops and numpy's rules (``operators.NUMPY_RULES``, the serve tier's)
    the kernel implements for the dtype qualify (custom ops take the
    chained fold, as the JAX package's host-only ops do); the
    ``fused_fold`` knob set to ``off`` sends every fold there too."""
    from . import config
    from .kernels.fold_ops import kernel_op
    from .operators import _PREDEFINED, NUMPY_RULES
    if (_PREDEFINED.get(op.name) is not op
            and NUMPY_RULES.get(op.name) is not op):
        return None
    name = kernel_op(op.name, dtype)
    if not _fused.supports(name, dtype):
        return None
    if config.load().fused_fold == "off":
        return None
    return name


def _fused_reduce_candidate(op: Op, arrs: Sequence[Any]) -> Optional[str]:
    """The kernel op name when the fused fold kernel takes this fold, else
    None. Decided up front from the operands, never by trying: same-shape
    tensors of one dtype on one device, and :func:`_kernel_op`."""
    a0 = arrs[0]
    if not all(is_torch_tensor(a) and a.shape == a0.shape
               and a.dtype == a0.dtype and a.device == a0.device
               for a in arrs):
        return None
    return _kernel_op(op, a0.dtype)


def _tensor_fold(arrs: Sequence[Any], op: Op, out: Optional[Any] = None):
    """The fold of tensor contributions (counterpart of the JAX package's
    ``_jitted_fold``): the fused kernel when :func:`_fused_reduce_candidate`
    admits the operands, else the chained PyTorch fold, counted in
    ``chained_folds``. Host numpy contributions beside tensors are moved to
    the first tensor's device first. ``out``, when given, receives the
    result (it may be the first operand itself: the RMA accumulate folds
    into the target range in place). Returns None when no operand is a
    tensor (the host fold applies)."""
    first = next((a for a in arrs if is_torch_tensor(a)), None)
    if first is None:
        return None
    arrs = [a if is_torch_tensor(a) else as_tensor(a, device=first.device)
            for a in arrs]
    if len(arrs) == 1 and out is None:
        return arrs[0]
    kop = _fused_reduce_candidate(op, arrs)
    if kop is not None:
        return _fused.fused_multi_reduce(arrs, kop, out=out)
    global chained_folds
    with _chained_lock:
        chained_folds += 1
    res = functools.reduce(op, arrs)
    return res if out is None else out.copy_(res)


def _reduce_arrays(arrs: Sequence[Any], op: Op,
                   schedule: Optional[ChunkSchedule] = None) -> Any:
    """Rank-ordered elementwise reduction (deterministic; MPI rank order).
    With a chunk ``schedule`` (overlap engine), host folds run chunk-by-chunk
    — cache-resident working set, progress notes per chunk, and on the
    multi-process tier the per-chunk structure is what lets the star root
    fold chunk k while the drainer still receives chunk k+1."""
    out = _tensor_fold(arrs, op)
    if out is not None:
        return out
    if schedule is not None and len(arrs) > 1:
        out = _chunked_fold(arrs, op, schedule)
        if out is not None:
            return out
    return functools.reduce(op, arrs)


def _chunked_fold(arrs: Sequence[Any], op: Op,
                  schedule: ChunkSchedule) -> Optional[Any]:
    """Chunk-pipelined host fold. Elementwise rank-order folds are
    chunk-separable, so this is BITWISE-IDENTICAL to the monolithic
    ``functools.reduce``: ufunc-backed ops (SUM/PROD/MIN/MAX/B*) fold each
    chunk in place into one preallocated output (zero temporaries — the
    monolithic fold allocates n-1 full-size intermediates); other
    elementwise ops fold per-chunk and concatenate, preserving the exact
    dtype-promotion behavior. Returns None when the operands don't fit
    (non-numpy, object dtype, ragged sizes) and the caller's monolithic
    fold applies."""
    from .operators import is_elementwise
    if not is_elementwise(op):
        return None     # unknown custom fn might couple elements: monolithic
    first = arrs[0]
    if any(not isinstance(a, np.ndarray) or a.dtype == object for a in arrs):
        return None
    if any(a.size != schedule.count for a in arrs):
        return None
    flats = [a.reshape(-1) for a in arrs]
    prog = progress_begin(schedule.nchunks, "fold")
    if op.ufunc is not None and all(a.dtype == first.dtype for a in arrs):
        out = np.empty(schedule.count, dtype=first.dtype)
        for lo, hi in schedule:
            np.copyto(out[lo:hi], flats[0][lo:hi])
            for a in flats[1:]:
                op.ufunc(out[lo:hi], a[lo:hi], out=out[lo:hi])
            progress_note(prog)
        return out
    parts = []
    for lo, hi in schedule:
        parts.append(functools.reduce(op, [a[lo:hi] for a in flats]))
        progress_note(prog)
    return np.concatenate(parts)


def _scan_arrays(cs: Sequence[Any], op: Op) -> list:
    """Inclusive prefixes in rank order (same fold, all partials kept)."""
    outs: list = []
    acc = None
    for c in cs:
        acc = c if acc is None else op(acc, c)
        outs.append(acc)
    return outs


def _same_kind(parts: Sequence[Any]):
    """``(arrays, xp)``: the parts as numpy arrays with ``xp`` numpy, or,
    when any part is a tensor, all as tensors on its device with ``xp``
    torch."""
    first = next((p for p in parts if is_torch_tensor(p)), None)
    if first is None:
        return [np.asarray(p) for p in parts], np
    return [as_tensor(p, device=first.device) for p in parts], torch


def _is_none(x: Any) -> bool:
    return x is None or isinstance(x, _InPlace)


# ---------------------------------------------------------------------------
# Intercommunicator collectives (MPI_ROOT semantics).
# The reference reaches these through libmpi, which honors collectives on the
# intercomms Comm_spawn creates (MPI.jl src/comm.jl:135-162). Here
# they run over the intercomm's two-group rendezvous: in the ROOT GROUP the
# sourcing rank passes MPI.ROOT and the rest pass MPI.PROC_NULL; the RECEIVING
# group passes the root's rank within the remote group.
# ---------------------------------------------------------------------------

def _inter_rooted(comm: Intercomm, root: Any, payload: Any, opname: str):
    """Two-group rooted rendezvous. Returns (got_value, value): got_value is
    True only for receiving-group ranks."""
    chan, slot, a, b = comm.two_group_channel()
    in_a = slot < len(a)
    if root == ROOT:
        contrib = ("root", payload, in_a)
    elif root == PROC_NULL:
        contrib = ("null", None, in_a)
    else:
        r = int(root)
        if not (0 <= r < comm.remote_size()):
            raise MPIError(f"invalid intercomm root {root!r}: pass MPI.ROOT "
                           f"(source), MPI.PROC_NULL (non-source, root group) "
                           f"or a remote-group rank < {comm.remote_size()}",
                           code=_ec.ERR_ROOT)
        contrib = ("recv", r, in_a)

    def combine(cs):
        roots = [i for i, c in enumerate(cs) if c[0] == "root"]
        if len(roots) != 1:
            raise CollectiveMismatchError(
                f"{opname}: exactly one rank must pass MPI.ROOT, got "
                f"{len(roots)}")
        ri = roots[0]
        root_in_a = cs[ri][2]
        root_idx = ri if root_in_a else ri - len(a)
        out = []
        for i, (role, val, ia) in enumerate(cs):
            if role == "root":
                out.append((False, None))
            elif role == "null":
                if ia != root_in_a:
                    raise CollectiveMismatchError(
                        f"{opname}: rank in the receiving group passed "
                        f"MPI.PROC_NULL; receivers must pass the root's "
                        f"remote-group rank")
                out.append((False, None))
            else:
                if ia == root_in_a:
                    raise CollectiveMismatchError(
                        f"{opname}: rank in the root group passed a root rank "
                        f"({val}); non-source root-group ranks pass "
                        f"MPI.PROC_NULL")
                if val != root_idx:
                    raise CollectiveMismatchError(
                        f"{opname}: receiving group names root {val} but the "
                        f"source is remote-group rank {root_idx}")
                out.append((True, cs[ri][1]))
        return out

    return _ordered_run(comm, lambda: chan.run(slot, contrib, combine, opname))


def _inter_barrier(comm: Intercomm) -> None:
    chan, slot, a, b = comm.two_group_channel()
    _ordered_run(comm, lambda: chan.run(
        slot, None, lambda cs: [None] * len(cs), f"IBarrier@{comm.cid}"))


def _inter_bcast_buf(buf: Any, count: Optional[int], root: Any,
                     comm: Intercomm) -> Any:
    opname = f"InterBcast@{comm.cid}"
    if root == ROOT:
        n = element_count(buf) if count is None else count
        assert_minlength(buf, n)
        _inter_rooted(comm, root, (to_wire(buf, n), n), opname)
        return buf
    got, res = _inter_rooted(comm, root, None, opname)
    if got:
        val, n_src = res
        n = n_src if count is None else count
        assert_minlength(buf, n)
        write_flat(buf, val, n)
    return buf


def _inter_bcast_obj(obj: Any, root: Any, comm: Intercomm) -> Any:
    opname = f"interbcast@{comm.cid}"
    if root == ROOT:
        try:
            payload = ("pickle", _serialization.dumps(obj))
        except Exception:
            payload = ("ref", obj)
        _inter_rooted(comm, root, payload, opname)
        return obj
    got, res = _inter_rooted(comm, root, None, opname)
    if not got:
        return obj        # PROC_NULL participant: argument untouched
    kind, data = res
    return pickle.loads(data) if kind == "pickle" else data


# ---------------------------------------------------------------------------
# Barrier
# ---------------------------------------------------------------------------

def Barrier(comm: Comm) -> None:
    """Block until every rank of comm arrives (src/collective.jl:15-19).
    On an intercommunicator: until every rank of BOTH groups arrives."""
    if isinstance(comm, Intercomm):
        return _inter_barrier(comm)
    algo = _maybe_explore(comm, "barrier", None,
                          _coll_select(comm, "barrier", None))
    _run(comm, None, lambda cs: [None] * len(cs), f"Barrier@{comm.cid}",
         plan=("barrier", algo), _sig={"algo": algo})


# ---------------------------------------------------------------------------
# Bcast / bcast
# ---------------------------------------------------------------------------

def Bcast(buf: Any, *args) -> Any:
    """``Bcast(buf, [count,] root, comm)`` — broadcast root's buffer into every
    rank's buffer, mutating (src/collective.jl:29-42). Returns buf."""
    if len(args) == 2:
        count, (root, comm) = None, args
    elif len(args) == 3:
        count, root, comm = args
    else:
        raise TypeError("Bcast(buf, [count,] root, comm)")
    if isinstance(comm, Intercomm):
        return _inter_bcast_buf(buf, count, root, comm)
    rank = comm.rank()
    n = element_count(buf) if count is None else count
    assert_minlength(buf, n)
    payload = to_wire(buf, n) if rank == root else None

    def combine(cs, rt):
        val = cs[rt]
        return [val] * len(cs)

    dt = getattr(extract_array(buf), "dtype", None)
    nbytes = int(n) * dt.itemsize if dt is not None and dt != object else None
    algo = _maybe_explore(
        comm, "bcast", nbytes,
        _coll_select(comm, "bcast", nbytes, numeric=nbytes is not None),
        numeric=nbytes is not None)
    val = _run_rooted(comm, root, payload, combine, f"Bcast@{comm.cid}",
                      plan=("bcast", root, algo),
                      _sig={"count": int(n), "dtype": str(dt), "algo": algo})
    if rank != root:
        write_flat(buf, val, n)
    return buf


def bcast(obj: Any, root: int, comm: Comm) -> Any:
    """Broadcast an arbitrary serialized object (src/collective.jl:44-60).

    The reference's two-phase length+payload dance collapses: the rendezvous
    carries dynamic sizes natively. Serialization round-trips give each rank
    its own copy; closures/lambdas/local classes travel by value on every
    tier via :mod:`tpu_mpi_torch.serialization` (ref broadcasts a *function*,
    test/test_bcast.jl:38-55). Truly unserializable objects (sockets,
    locks) fall back to by-reference sharing, thread tier only."""
    if isinstance(comm, Intercomm):
        return _inter_bcast_obj(obj, root, comm)
    rank = comm.rank()
    if rank == root:
        try:
            payload = ("pickle", _serialization.dumps(obj))
        except Exception:
            payload = ("ref", obj)
    else:
        payload = None

    def combine(cs, rt):
        val = cs[rt]
        return [val] * len(cs)

    algo = _maybe_explore(comm, "bcast", None,
                          _coll_select(comm, "bcast", None, numeric=False),
                          numeric=False)
    kind, data = _run_rooted(comm, root, payload, combine, f"bcast@{comm.cid}",
                             plan=("bcast", root, algo), _sig={"algo": algo})
    if rank == root:
        return obj
    return pickle.loads(data) if kind == "pickle" else data


# ---------------------------------------------------------------------------
# Scatter / Scatterv
# ---------------------------------------------------------------------------

def Scatter(*args) -> Any:
    """``Scatter(send, recv, [count,] root, comm)`` mutating |
    ``Scatter(send, count, root, comm)`` allocating (src/collective.jl:90-129).
    Root's send buffer is split into comm-size equal chunks in rank order;
    ``None``/IN_PLACE marks the insignificant buffer."""
    if len(args) == 5:
        sendbuf, recvbuf, count, root, comm = args
        alloc = False
    elif len(args) == 4 and isinstance(args[1], (int, np.integer)):
        sendbuf, count, root, comm = args
        recvbuf, alloc = None, True
    elif len(args) == 4:
        sendbuf, recvbuf, root, comm = args
        count, alloc = None, False
    else:
        raise TypeError("Scatter(send, recv, [count,] root, comm) or Scatter(send, count, root, comm)")
    rank, size = comm.rank(), comm.size()
    isroot = rank == root
    if count is None and not alloc:
        count = element_count(recvbuf) if not _is_none(recvbuf) else element_count(sendbuf) // size
    if isroot:
        if _is_none(sendbuf):
            raise MPIError("root must supply a send buffer to Scatter")
        assert_minlength(sendbuf, count * size)
    if not alloc and not (isroot and _is_none(recvbuf)):
        assert_minlength(recvbuf, count)   # before the rendezvous (see Gather)
    payload = to_wire(sendbuf, count * size) if isroot else None

    def combine(cs, rt):
        data = cs[rt]
        return [data[r * count:(r + 1) * count] for r in range(len(cs))]

    # The decision size must be rank-uniform: in the allocating flavor only
    # the root holds a buffer, so size-blind selection (None) keeps every
    # rank on the same algorithm.
    if alloc:
        nbytes = None
    else:
        dt = getattr(extract_array(sendbuf if isroot else recvbuf),
                     "dtype", None)
        nbytes = (count * size * dt.itemsize
                  if dt is not None and dt != object else None)
    algo = _maybe_explore(comm, "scatter", nbytes,
                          _coll_select(comm, "scatter", nbytes))
    chunk = _run_rooted(comm, root, payload, combine, f"Scatter@{comm.cid}",
                        plan=("scatter", algo), _sig={"algo": algo})
    if alloc:
        template = sendbuf if isroot else None
        return clone_like(template, chunk) if template is not None else to_numpy(chunk)
    if isroot and _is_none(recvbuf):
        return sendbuf          # IN_PLACE at root: data already in place
    write_flat(recvbuf, chunk, count)
    return recvbuf


def Scatterv(*args) -> Any:
    """``Scatterv(send, recv, counts, root, comm)`` mutating |
    ``Scatterv(send, counts, root, comm)`` allocating (src/collective.jl:156-196).
    Displacements are the exclusive prefix sum of counts (:169)."""
    if len(args) == 5:
        sendbuf, recvbuf, counts, root, comm = args
        alloc = False
    elif len(args) == 4:
        sendbuf, counts, root, comm = args
        recvbuf, alloc = None, True
    else:
        raise TypeError("Scatterv(send, [recv,] counts, root, comm)")
    rank, size = comm.rank(), comm.size()
    isroot = rank == root
    counts = [int(c) for c in counts]
    if isroot:
        if _is_none(sendbuf):
            raise MPIError("root must supply a send buffer to Scatterv")
        assert_minlength(sendbuf, sum(counts))
    # counts are significant only at the root (MPI semantics): ship them in
    # the root's contribution so a divergent non-root list cannot influence
    # the slicing depending on rendezvous arrival order.
    payload = (to_wire(sendbuf, sum(counts)), counts) if isroot else None

    def combine(cs, rt):
        data, root_counts = cs[rt]
        displs = np.concatenate([[0], np.cumsum(root_counts)])
        return [data[displs[r]:displs[r] + root_counts[r]] for r in range(len(cs))]

    chunk = _run_rooted(comm, root, payload, combine, f"Scatterv@{comm.cid}")
    if alloc:
        template = sendbuf if isroot else None
        return clone_like(template, chunk) if template is not None else to_numpy(chunk)
    if isroot and _is_none(recvbuf):
        return sendbuf
    n = element_count(chunk)
    assert_minlength(recvbuf, n)
    write_flat(recvbuf, chunk, n)
    return recvbuf


# ---------------------------------------------------------------------------
# Gather / Gatherv / Allgather / Allgatherv
# ---------------------------------------------------------------------------

def Gather(*args) -> Any:
    """``Gather(send, recv, [count,] root, comm)`` mutating |
    ``Gather(send, [count,] root, comm)`` allocating — works for arrays and
    scalar objects (src/collective.jl:230-275)."""
    if len(args) == 5:
        sendbuf, recvbuf, count, root, comm = args
        alloc = False
    elif len(args) == 4 and isinstance(args[1], (int, np.integer)):
        sendbuf, count, root, comm = args
        recvbuf, alloc = None, True
    elif len(args) == 4:
        sendbuf, recvbuf, root, comm = args
        count, alloc = None, False
    elif len(args) == 3:
        sendbuf, root, comm = args
        recvbuf, count, alloc = None, None, True
    else:
        raise TypeError("Gather(send, [recv,] [count,] root, comm)")
    return _gather_impl(sendbuf, recvbuf, count, root, comm, alloc, all_ranks=False)


def Allgather(*args) -> Any:
    """``Allgather(send, recv, count, comm)`` | ``Allgather(IN_PLACE, buf,
    count, comm)`` | ``Allgather(send, [count,] comm)`` allocating
    (src/collective.jl:295-335). Every rank receives the concatenation."""
    if len(args) == 4:
        sendbuf, recvbuf, count, comm = args
        alloc = False
    elif len(args) == 3 and isinstance(args[1], (int, np.integer)):
        sendbuf, count, comm = args
        recvbuf, alloc = None, True
    elif len(args) == 2:
        sendbuf, comm = args
        recvbuf, count, alloc = None, None, True
    else:
        raise TypeError("Allgather(send, [recv,] [count,] comm)")
    return _gather_impl(sendbuf, recvbuf, count, None, comm, alloc, all_ranks=True)


def _gather_impl(sendbuf, recvbuf, count, root, comm, alloc, all_ranks):
    rank, size = comm.rank(), comm.size()
    isroot = all_ranks or rank == root
    inplace = isinstance(sendbuf, _InPlace) or sendbuf is None
    if inplace:
        # IN_PLACE: rank's own chunk already sits at recvbuf[rank*count:...]
        # (src/collective.jl:309-313 in-place Allgather!).
        if _is_none(recvbuf):
            raise MPIError("IN_PLACE gather needs the send-recv buffer")
        if count is None:
            count = element_count(recvbuf) // size
        arr = to_wire(recvbuf, element_count(recvbuf))
        payload = arr.reshape(-1)[rank * count:(rank + 1) * count]
    else:
        if count is None:
            count = element_count(sendbuf)
        assert_minlength(sendbuf, count)
        payload = to_wire(sendbuf, count)
    # Bounds-check the significant recv buffer *before* the rendezvous, like
    # the reference checks before the ccall (src/collective.jl:230-275) — a
    # failing rank must not have half-entered the collective.
    if not alloc and isroot and not _is_none(recvbuf):
        assert_minlength(recvbuf, count * size)

    def combine(cs, rt=None):
        arrs, xp = _same_kind(cs)
        full = xp.concatenate([a.reshape(-1) for a in arrs])
        if rt is None:                  # Allgather: everyone needs it
            return [full] * len(cs)
        # rooted Gather: only root receives the concatenation — on the
        # multi-process star this keeps egress at ~zero instead of P×payload
        #
        return [full if r == rt else None for r in range(len(cs))]

    nb = _wire_nbytes(payload)
    if all_ranks:
        # multi-process tier: big uniform blocks travel a ring (one hop per
        # block per step) instead of star ingress + P x egress at the root;
        # the selection is keyed on the per-rank block size, matching the
        # ring's per-hop cost
        algo = _maybe_explore(
            comm, "allgather", nb,
            _coll_select(comm, "allgather", nb, numeric=nb is not None),
            numeric=nb is not None)
        full = _run(comm, payload, combine, f"Allgather@{comm.cid}",
                    plan=("allgather", algo), _sig={"algo": algo})
    else:
        gnb = nb * size if nb is not None else None
        algo = _maybe_explore(comm, "gather", gnb,
                              _coll_select(comm, "gather", gnb))
        full = _run_rooted(comm, root, payload, combine, f"Gather@{comm.cid}",
                           plan=("gather", algo), _sig={"algo": algo})
    if not isroot:
        return None if alloc else recvbuf
    if alloc:
        template = sendbuf if not inplace else recvbuf
        return clone_like(template, full)
    write_flat(recvbuf, full, count * size)
    return recvbuf


def Gatherv(*args) -> Any:
    """``Gatherv(send, recv, counts, root, comm)`` mutating |
    ``Gatherv(send, counts, root, comm)`` allocating (src/collective.jl:363-403)."""
    if len(args) == 5:
        sendbuf, recvbuf, counts, root, comm = args
        alloc = False
    elif len(args) == 4:
        sendbuf, counts, root, comm = args
        recvbuf, alloc = None, True
    else:
        raise TypeError("Gatherv(send, [recv,] counts, root, comm)")
    return _gatherv_impl(sendbuf, recvbuf, counts, root, comm, alloc, all_ranks=False)


def Allgatherv(*args) -> Any:
    """``Allgatherv(send, recv, counts, comm)`` | ``Allgatherv(IN_PLACE, buf,
    counts, comm)`` | allocating ``Allgatherv(send, counts, comm)``
    (src/collective.jl:424-461)."""
    if len(args) == 4:
        sendbuf, recvbuf, counts, comm = args
        alloc = False
    elif len(args) == 3:
        sendbuf, counts, comm = args
        recvbuf, alloc = None, True
    else:
        raise TypeError("Allgatherv(send, [recv,] counts, comm)")
    return _gatherv_impl(sendbuf, recvbuf, counts, None, comm, alloc, all_ranks=True)


def _gatherv_impl(sendbuf, recvbuf, counts, root, comm, alloc, all_ranks):
    rank, size = comm.rank(), comm.size()
    isroot = all_ranks or rank == root
    counts = [int(c) for c in counts]
    displs = np.concatenate([[0], np.cumsum(counts)])  # exclusive prefix (:365,:425)
    inplace = isinstance(sendbuf, _InPlace) or sendbuf is None
    if inplace:
        if _is_none(recvbuf):
            raise MPIError("IN_PLACE gatherv needs the send-recv buffer")
        arr = to_wire(recvbuf, element_count(recvbuf))
        payload = arr.reshape(-1)[displs[rank]:displs[rank] + counts[rank]]
    else:
        assert_minlength(sendbuf, counts[rank])
        payload = to_wire(sendbuf, counts[rank])
    if not alloc and isroot and not _is_none(recvbuf):
        assert_minlength(recvbuf, sum(counts))   # before the rendezvous

    def combine(cs, rt=None):
        arrs, xp = _same_kind(cs)
        full = xp.concatenate([a.reshape(-1) for a in arrs])
        if rt is None:                  # Allgatherv: everyone needs it
            return [full] * len(cs)
        # rooted Gatherv: root-only result
        return [full if r == rt else None for r in range(len(cs))]

    if all_ranks:
        # ragged ring tier (multi-process): the counts list is replicated by
        # the API contract, so a size gate on the TOTAL is deterministic
        # across ranks even though per-rank blocks differ
        total_bytes = int(sum(counts)) * getattr(
            getattr(payload, "dtype", None), "itemsize", 0)
        dt = getattr(payload, "dtype", None)
        numeric = dt is not None and dt != object
        gnb = total_bytes if numeric else None
        algo = _maybe_explore(comm, "allgatherv", gnb,
                              _coll_select(comm, "allgatherv", gnb,
                                           numeric=numeric),
                              numeric=numeric)
        full = _run(comm, payload, combine, f"Allgatherv@{comm.cid}",
                    plan=("allgatherv", total_bytes, tuple(counts), algo),
                    _sig={"algo": algo})
    else:
        full = _run_rooted(comm, root, payload, combine, f"Gatherv@{comm.cid}")
    if not isroot:
        return None if alloc else recvbuf
    if alloc:
        template = sendbuf if not inplace else recvbuf
        return clone_like(template, full)
    write_flat(recvbuf, full, sum(counts))
    return recvbuf


# ---------------------------------------------------------------------------
# Alltoall / Alltoallv
# ---------------------------------------------------------------------------

def Alltoall(*args) -> Any:
    """``Alltoall(send, recv, count, comm)`` | ``Alltoall(IN_PLACE, buf, count,
    comm)`` | allocating ``Alltoall(send, count, comm)``
    (src/collective.jl:489-532). Rank r sends its chunk j to rank j's slot r."""
    if len(args) == 4:
        sendbuf, recvbuf, count, comm = args
        alloc = False
    elif len(args) == 3:
        sendbuf, count, comm = args
        recvbuf, alloc = None, True
    else:
        raise TypeError("Alltoall(send, [recv,] count, comm)")
    rank, size = comm.rank(), comm.size()
    count = int(count)
    inplace = isinstance(sendbuf, _InPlace) or sendbuf is None
    src = recvbuf if inplace else sendbuf
    assert_minlength(src, count * size)
    if not alloc and not inplace:
        assert_minlength(recvbuf, count * size)   # before the rendezvous
    payload = to_wire(src, count * size)

    def combine(cs):
        arrs, xp = _same_kind(cs)
        mats = [a.reshape(len(cs), count) for a in arrs]
        return [xp.concatenate([m[r] for m in mats]) for r in range(len(cs))]

    # multi-process tier: large exchanges go direct pairwise (each segment
    # one hop) instead of O(P²·seg) through the star root
    nb = _wire_nbytes(payload)
    algo = _maybe_explore(
        comm, "alltoall", nb,
        _coll_select(comm, "alltoall", nb, numeric=nb is not None),
        numeric=nb is not None)
    mine = _run(comm, payload, combine, f"Alltoall@{comm.cid}",
                plan=("alltoall", algo), _sig={"algo": algo})
    if alloc:
        return clone_like(src, mine)
    write_flat(recvbuf, mine, count * size)
    return recvbuf


def Alltoallv(*args) -> Any:
    """``Alltoallv(send, recv, scounts, rcounts, comm)`` mutating | allocating
    ``Alltoallv(send, scounts, rcounts, comm)`` (src/collective.jl:545-578)."""
    if len(args) == 5:
        sendbuf, recvbuf, scounts, rcounts, comm = args
        alloc = False
    elif len(args) == 4:
        sendbuf, scounts, rcounts, comm = args
        recvbuf, alloc = None, True
    else:
        raise TypeError("Alltoallv(send, [recv,] scounts, rcounts, comm)")
    rank, size = comm.rank(), comm.size()
    scounts = [int(c) for c in scounts]
    rcounts = [int(c) for c in rcounts]
    assert_minlength(sendbuf, sum(scounts))
    if not alloc:
        assert_minlength(recvbuf, sum(rcounts))   # before the rendezvous
    payload = (to_wire(sendbuf, sum(scounts)), scounts)

    def combine(cs):
        datas, xp = _same_kind([c[0] for c in cs])
        outs = []
        for r in range(len(cs)):
            parts = []
            for s in range(len(cs)):
                sc = cs[s][1]
                d = int(np.sum(sc[:r]))
                parts.append(datas[s].reshape(-1)[d:d + sc[r]])
            outs.append(xp.concatenate(parts) if parts else xp.zeros(0))
        return outs

    # per-rank send totals differ, so the size-blind (None) decision keeps
    # the selection rank-uniform; pairwise is gated on dtype alone
    dt = getattr(payload[0], "dtype", None)
    numeric = dt is not None and dt != object
    algo = _maybe_explore(comm, "alltoallv", None,
                          _coll_select(comm, "alltoallv", None,
                                       numeric=numeric),
                          numeric=numeric)
    # per-peer counts ride the event IR so the trace verifier can check
    # rank i's scounts[j] against rank j's rcounts[i] (T202 family)
    mine = _run(comm, payload, combine, f"Alltoallv@{comm.cid}",
                plan=("alltoallv", algo),
                _sig={"algo": algo, "scounts": list(scounts),
                      "rcounts": list(rcounts)})
    if alloc:
        return clone_like(sendbuf, mine)
    write_flat(recvbuf, mine, sum(rcounts))
    return recvbuf


# ---------------------------------------------------------------------------
# Reduce / Allreduce / Scan / Exscan / Reduce_scatter
# ---------------------------------------------------------------------------

def _parse_reduce_args(args, has_root: bool, name: str):
    """Shared arg parsing: (send, [recv, [count,]] op, [root,] comm)."""
    tail = 2 if has_root else 1
    n = len(args)
    comm = args[-1]
    root = int(args[-2]) if has_root else None
    op = args[-(tail + 1)]
    head = args[:n - tail - 1]
    if len(head) == 1:
        sendbuf, recvbuf, count = head[0], None, None
        alloc = not isinstance(sendbuf, _InPlace)
    elif len(head) == 2:
        sendbuf, recvbuf, count = head[0], head[1], None
        alloc = False
    elif len(head) == 3:
        sendbuf, recvbuf, count = head
        count = int(count)
        alloc = False
    else:
        raise TypeError(f"{name}(send, [recv, [count,]] op, "
                        + ("root, comm)" if has_root else "comm)"))
    return sendbuf, recvbuf, count, as_op(op), root, comm, alloc


def _reduce_plan(comm: Comm, name: str, mode: str, op: Op, count: int,
                 payload: Any) -> CollectivePlan:
    """The pre-resolved plan for one reduce-family signature (the overlap
    engine's persistent-plan piece): opname tag, combine closure, trace
    signature, multi-process algorithm hint and chunk schedule are built
    once per (comm, flavor, op, count, dtype, array kind) and reused by
    every later same-shape call — the training-loop case pays dict lookups
    instead of closure/format/config work per collective."""
    from . import config
    dtype = getattr(payload, "dtype", None)
    key = (comm.cid, name, mode, op, int(count), str(dtype),
           type(payload).__name__)
    plan = _plans.get(key)
    if plan is not None:
        return plan
    itemsize = getattr(dtype, "itemsize", 0)
    schedule = (ChunkSchedule.maybe(count, itemsize)
                if mode == "reduce" else None)

    def combine(cs, rt=None):
        n = len(cs)
        if mode == "reduce":
            total = _reduce_arrays(cs, op, schedule=schedule)
            if rt is None:              # Allreduce: everyone needs it
                return [total] * n
            # rooted Reduce: ship the combined payload to root only — star
            # egress drops from P×payload to ~zero
            return [total if r == rt else None for r in range(n)]
        if mode == "scan":
            return _scan_arrays(cs, op)
        if mode == "exscan":
            # exscan[i] = scan over ranks 0..i-1; rank 0's slot is undefined.
            return [None, *_scan_arrays(cs[:-1], op)]
        raise AssertionError(mode)

    # The multi-process tier picks its algorithm (star / shm / recursive
    # doubling / Rabenseifner / ring / binomial) from the portfolio once
    # per signature; order-sensitive modes (Scan/Exscan) stay on the
    # monolithic star. The selection is cached inside this plan and
    # invalidated with it on config reloads.
    if mode == "reduce":
        from .operators import is_elementwise
        numeric = dtype is not None and str(dtype) != "object"
        nbytes = int(count) * itemsize if numeric and itemsize else None
        coll = "reduce" if name == "Reduce" else "allreduce"
        algo = _coll_select(comm, coll, nbytes,
                            commutative=bool(op.commutative),
                            elementwise=is_elementwise(op), numeric=numeric)
        hint = (coll, op, algo)
    else:
        algo, hint = "star", None
    sig = {"count": int(count), "dtype": str(dtype), "algo": algo}
    plan = CollectivePlan(f"{name}@{comm.cid}", op, combine, sig, hint,
                          schedule, config.GENERATION, algo=algo)
    _plans.put(key, plan)
    return plan


def _explore_reduce_variant(comm: Comm, cplan: CollectivePlan, op: Op,
                            count: int, payload: Any) -> CollectivePlan:
    """Online-tuning hook for the reduce family: plan-cache hits skip
    ``_coll_select`` entirely, so with the bandit live we re-run the
    decision through :func:`_maybe_explore` per call and — only on the
    exploration slots — hand back a shallow variant of the cached plan
    with the algorithm rebound. The variant shares the combine closure and
    chunk schedule; the cached plan itself is never mutated, so steady
    traffic keeps its zero-overhead path."""
    from .operators import is_elementwise
    coll, hop, _ = cplan.hint
    dtype = getattr(payload, "dtype", None)
    itemsize = getattr(dtype, "itemsize", 0)
    numeric = dtype is not None and str(dtype) != "object"
    nbytes = int(count) * itemsize if numeric and itemsize else None
    algo = _maybe_explore(comm, coll, nbytes, cplan.algo,
                          commutative=bool(op.commutative),
                          elementwise=is_elementwise(op), numeric=numeric)
    if algo == cplan.algo:
        return cplan
    return CollectivePlan(cplan.opname, cplan.op, cplan.combine,
                          dict(cplan.sig, algo=algo), (coll, hop, algo),
                          cplan.schedule, cplan.generation, algo=algo)


def _auto_arm_gate(comm, args, sendbuf, recvbuf, op, count, payload, alloc):
    """Promote a repeated plain ``Allreduce``
    signature onto the registered persistent path with zero API change.

    Returns ``(runner, model)``. ``runner`` — when the signature's
    consecutive-identical-call streak has crossed
    ``config.auto_arm_threshold`` and a :class:`PlanRegistration` bound —
    executes the whole armed round (rendezvous + copy-out) and the caller
    returns its value directly; ``None`` means take the generic path.
    ``model`` is non-None only under tracing with ``auto_arm_donate`` opted
    in: traced runs always DEMOTE to the fully-evented legacy lane (bitwise
    identical by construction), but the donation window the untraced run
    would have had is modeled with synthetic Start/Wait events so the R302
    pass can still flag a stale aliased result being fed back in — the
    caller invokes ``model(out)`` with the allocating flavor's result.

    Demotion is loud-free and total: trace arming, outstanding nonblocking
    traffic, buffer-identity churn, shape/dtype churn on the lane
    (``PlanCache.auto_note``), ``Comm.free`` (``plans.invalidate``), and
    config reloads (generation check below) all push the signature back to
    the generic star. Without ``auto_arm_donate`` the armed lane runs the
    copy-out contract (``_register_allreduce(donate=False)``), so no user-
    visible aliasing exists for R302 to worry about."""
    from . import config
    from ._runtime import current_env
    cfg = config.load()
    if not (cfg.auto_arm and cfg.registered_buffers):
        return None, None
    env = current_env()
    if env is None:
        return None, None
    ctx, world_rank = env
    cid = comm.cid
    # per-rank key: the thread tier shares ONE PlanCache across rank
    # threads, and each rank's streak/arming is its own
    key = (cid, comm.rank(), "Allreduce", op, int(count),
           str(getattr(payload, "dtype", None)), type(payload).__name__)
    e = _plans.auto_note(key, sendbuf, recvbuf)
    if e is None:
        return None, None
    threshold = max(int(cfg.auto_arm_threshold), 1)

    if _ev.enabled():
        if e.armed:
            _plans.auto_demote(e)
        if not (cfg.auto_arm_donate and alloc and e.streak >= threshold):
            return None, None
        # model the donated-result ring the untraced run would alias:
        # round k's Start re-donates the slot under round k-2's result
        rnd = e.rounds
        e.rounds += 1
        inval = None
        for r, res in e.results:
            if r == rnd - 2:
                inval = _ev.buf_id(res)
        _ev.record_start(comm, "pallreduce", id(e), rnd, invalidates=inval)

        def model(out):
            e.results.append((rnd, out))
            _ev.record_wait(comm, "pallreduce", id(e), rnd, result=out)
        return None, model

    st = _nb_state(ctx, cid, world_rank, create=False)
    if st is not None and st.outstanding:
        # in-flight I* ops own the initiation order; stay generic (the
        # generic path runs through the worker) and drop the armed round
        if e.armed:
            _plans.auto_demote(e)
        return None, None

    reg = e.reg
    if reg is not None and (reg.released or reg.generation
                            != config.GENERATION):
        _plans.auto_demote(e)
        reg = None
    if reg is None:
        if e.streak < threshold or e.ineligible_gen == config.GENERATION:
            return None, None
        reg = _register_allreduce(comm, args, donate=cfg.auto_arm_donate)
        if reg is None or not reg.knob_on:
            if reg is not None:
                _registry.discard(reg)
            e.ineligible_gen = config.GENERATION
            return None, None
        _plans.auto_bind(e, reg)

    # publish the front door: the NEXT identical call dispatches from
    # Allreduce() itself on one dict probe + identity compares, skipping
    # argument parsing and this key construction (_auto_hot_run)
    _plans.auto_hot_set((cid, key[1]),
                        (args, e, sendbuf,
                         getattr(sendbuf, "nbytes", None)))

    def runner():
        _plans.auto_hit(e)
        # flush this thread's stacked fast-armed persistent rounds first
        # so initiation order stays program order; the outstanding-work
        # check _ordered_run would redo just happened above
        if not getattr(_nb_worker_tls, "active", False):
            _demote_fast_armed(cid)
        return reg.run_round()
    return runner, None


_AUTO_MISS = object()


def _auto_hot_run(args: tuple) -> Any:
    """Front door: dispatch a repeat of an already-armed plain
    ``Allreduce`` straight to its registered round on one dict probe plus
    per-element identity compares against the exact argument tuple that
    armed — skipping argument parsing and signature-key construction, the
    two per-call costs that kept the auto-armed lane measurably over the
    hand-armed Start/Wait figure. Any mismatch — different argument
    objects, tracing armed, a released or stale-generation registration,
    outstanding nonblocking traffic, an in-place resize of the send
    operand — returns ``_AUTO_MISS`` and the call falls through to
    :func:`_reduce_family`, whose full gate owns every demotion edge."""
    comm = args[-1]
    if not isinstance(comm, Comm):
        return _AUTO_MISS
    try:
        lane = (comm.cid, comm.rank())
    except Exception:
        return _AUTO_MISS               # not Init'd etc.: legacy error path
    rec = _plans.auto_hot_get(lane)
    if rec is None:
        return _AUTO_MISS
    pargs, e, send, nbytes = rec
    if len(pargs) != len(args):
        return _AUTO_MISS
    for a, b in zip(pargs, args):
        if a is not b:
            return _AUTO_MISS
    from . import config
    reg = e.reg
    if reg is None or reg.generation != config.GENERATION \
            or getattr(send, "nbytes", None) != nbytes \
            or not reg.armable():
        return _AUTO_MISS
    # stats stay truthful without the table lock: every field touched here
    # is owned by this rank's thread (the signature key is per-(cid, rank))
    # except the aggregate hit counter, which tolerates a lost update
    e.calls += 1
    e.streak += 1
    e.hits += 1
    _plans.auto_hits += 1
    # same program-order rule as the gate's runner: stacked fast-armed
    # persistent rounds on this thread initiate first
    if not getattr(_nb_worker_tls, "active", False):
        _demote_fast_armed(lane[0])
    return reg.run_round()


def _reduce_family(args, has_root: bool, mode: str, name: str) -> Any:
    sendbuf, recvbuf, count, op, root, comm, alloc = _parse_reduce_args(args, has_root, name)
    rank, size = comm.rank(), comm.size()
    scalar_in = np.isscalar(sendbuf) or isinstance(sendbuf, (int, float, complex, bool, np.generic))
    inplace = isinstance(sendbuf, _InPlace)
    if inplace:
        if _is_none(recvbuf):
            raise MPIError(f"IN_PLACE {name} needs a buffer")
        sendbuf = recvbuf
    if count is None:
        count = element_count(sendbuf)
    assert_minlength(sendbuf, count)
    if recvbuf is not None and not _is_none(recvbuf) and not inplace:
        assert_minlength(recvbuf, count)
    if mode == "reduce":
        # Zero-copy contribution: the reduce fold's distributed output is
        # always FRESH data (for n >= 2 the fold allocates; for n == 1 every
        # consumer below copies or self-assigns), and every rank is blocked
        # in the rendezvous until the fold has run — so the live buffer is
        # safe to expose and the to_wire snapshot copy is pure overhead.
        # Scan/Exscan keep the snapshot: Exscan hands rank 0's contribution
        # to rank 1 AS-IS, aliasing rank 0's buffer after it returns.
        payload = wire_view(sendbuf, count)
    else:
        payload = to_wire(sendbuf, count)

    # auto-arm: a repeated same-signature plain Allreduce is
    # promoted onto the registered persistent path; the armed runner skips
    # plan lookup AND bandit exploration (auto-armed plans never explore —
    # the explored variant would fork the call off its registered opname
    # lockstep). Under tracing the gate only returns a trace model.
    _model = None
    if mode == "reduce" and not has_root and name == "Allreduce" \
            and not scalar_in:
        _runner, _model = _auto_arm_gate(comm, args, sendbuf, recvbuf, op,
                                         count, payload, alloc)
        if _runner is not None:
            return _runner()

    cplan = _reduce_plan(comm, name, mode, op, count, payload)
    if mode == "reduce" and _tune_online.state() is not None:
        cplan = _explore_reduce_variant(comm, cplan, op, count, payload)
    # Own the pvar op scope across BOTH the rendezvous (_run) and the
    # result consumption below, so the copy-out into the user's recvbuf
    # lands in the same phase breakdown as the channel's rendezvous/fold
    # spans (the inner _run sees the open scope and defers finalization).
    sc = _pv.op_begin() if (_pv.enabled() or _ev.enabled()) else None
    # while tracing, stamp the contribution buffer's identity into the
    # signature (copy — cplan.sig may be plan-cache shared) so the R302
    # pass can see a stale donated result fed back into a reduction
    sig = dict(cplan.sig, bufid=_ev.buf_id(sendbuf)) if _ev.enabled() \
        else cplan.sig
    try:
        pkey = _payload_key(cplan.sig)
        if has_root:
            result = _run_rooted(comm, root, payload, cplan.combine,
                                 cplan.opname, plan=cplan.hint, _sig=sig,
                                 stamp=pkey)
        else:
            result = _run(comm, payload, cplan.combine, cplan.opname,
                          plan=cplan.hint, _sig=sig, stamp=pkey)
        i_get_result = (not has_root) or rank == root
        if mode == "exscan" and result is None:
            # rank 0's Exscan output is undefined (src/collective.jl:834-855);
            # leave buffers untouched, return the input unchanged.
            if alloc:
                return sendbuf if scalar_in else clone_like(sendbuf, np.asarray(sendbuf))
            return recvbuf if not inplace else sendbuf
        if not i_get_result:
            return None if alloc else recvbuf
        if alloc:
            if scalar_in:
                out = np.asarray(result)
                return out.item() if out.ndim == 0 or out.size == 1 else out
            shaped = _shape_result(result, sendbuf, count)
            if sc is None:
                out = clone_like(sendbuf, shaped)
            else:
                t0 = _pv.monotonic()
                out = clone_like(sendbuf, shaped)
                sc.spans.append(("copy", t0, _pv.monotonic()))
            if _model is not None:
                _model(out)     # R302 donation-window model (auto-arm)
            return out
        target = sendbuf if inplace else recvbuf
        if sc is None:
            write_flat(target, result, count)
        else:
            t0 = _pv.monotonic()
            write_flat(target, result, count)
            sc.spans.append(("copy", t0, _pv.monotonic()))
        return target
    finally:
        if sc is not None:
            _pv.op_end(sc, comm, coll=name.lower(), algo=cplan.sig.get("algo"),
                       dtype=cplan.sig.get("dtype"),
                       nbytes=_pv.payload_nbytes(payload))


def _shape_result(result: Any, like: Any, count: int) -> Any:
    arr = extract_array(like)
    if arr is None or getattr(result, "shape", None) == arr.shape:
        return result   # metadata-only check; no dispatch on the hot lane
    if is_torch_tensor(result):
        if arr.numel() == count and result.numel() == count:
            return result.reshape(arr.shape)
        return result
    if arr.size == count and np.asarray(result).size == count:
        return np.asarray(result).reshape(arr.shape)
    return result


def Reduce(*args) -> Any:
    """``Reduce(send, recv, [count,] op, root, comm)`` | ``Reduce(IN_PLACE,
    buf, op, root, comm)`` | allocating ``Reduce(send, op, root, comm)``
    (src/collective.jl:605-666). Result lands on root only."""
    return _reduce_family(args, has_root=True, mode="reduce", name="Reduce")


def Allreduce(*args) -> Any:
    """``Allreduce(send, recv, [count,] op, comm)`` | ``Allreduce(IN_PLACE,
    buf, op, comm)`` | allocating ``Allreduce(send, op, comm)``
    (src/collective.jl:691-738). Deterministic rank-ordered reduction. A
    repeated identical call auto-arms onto the registered persistent path and repeat hits dispatch through the front door below."""
    if len(args) >= 3:
        out = _auto_hot_run(args)
        if out is not _AUTO_MISS:
            return out
    return _reduce_family(args, has_root=False, mode="reduce", name="Allreduce")


def Scan(*args) -> Any:
    """Inclusive prefix reduction over ranks (src/collective.jl:760-808)."""
    return _reduce_family(args, has_root=False, mode="scan", name="Scan")


def Exscan(*args) -> Any:
    """Exclusive prefix reduction; rank 0's result undefined
    (src/collective.jl:834-882)."""
    return _reduce_family(args, has_root=False, mode="exscan", name="Exscan")


def Reduce_scatter(sendbuf: Any, recvbuf: Any, counts: Sequence[int], op: Any,
                   comm: Comm) -> Any:
    """Reduce then scatter by counts — absent from the reference (SURVEY.md
    §2.3: trivially composable / native in XLA as psum_scatter); provided
    natively here."""
    rank, size = comm.rank(), comm.size()
    op = as_op(op)
    counts = [int(c) for c in counts]
    total = sum(counts)
    assert_minlength(sendbuf, total)
    payload = (to_wire(sendbuf, total), counts)

    def combine(cs):
        # Reduce_scatter has no root: every rank's counts must agree.
        lists = [c[1] for c in cs]
        if any(l != lists[0] for l in lists[1:]):
            raise MPIError(f"Reduce_scatter counts differ across ranks: {lists}",
                           code=_ec.ERR_COUNT)
        red = _reduce_arrays([c[0] for c in cs], op)
        displs = np.concatenate([[0], np.cumsum(lists[0])])
        return [red.reshape(-1)[displs[r]:displs[r] + lists[0][r]]
                for r in range(len(cs))]

    mine = _run(comm, payload, combine, f"Reduce_scatter@{comm.cid}")
    if recvbuf is None:
        return clone_like(sendbuf, mine)
    assert_minlength(recvbuf, counts[rank])
    write_flat(recvbuf, mine, counts[rank])
    return recvbuf


def Reduce_scatter_block(sendbuf: Any, recvbuf: Any, op: Any, comm: Comm) -> Any:
    """Equal-block Reduce_scatter (recvcount = sendcount / comm size)."""
    size = comm.size()
    n = element_count(sendbuf)
    if n % size != 0:
        raise MPIError(f"send count {n} not divisible by comm size {size}",
                       code=_ec.ERR_COUNT)
    return Reduce_scatter(sendbuf, recvbuf, [n // size] * size, op, comm)


# ---------------------------------------------------------------------------
# Nonblocking collectives (MPI-3 Ibarrier/Ibcast/Iallreduce/… — absent from
# the reference v0.14.2, SURVEY.md §2.3 note; provided natively, beyond
# parity). Each communicator gets a per-rank single-thread worker, so this
# rank's collectives INITIATE on the rendezvous in program order (the MPI
# ordering contract) while the caller overlaps compute or P2P. Completion
# integrates with the whole Wait/Test family via a Request subclass.
# ---------------------------------------------------------------------------

class CollRequest:
    """Request handle for a nonblocking collective.

    Duck-types the :class:`tpu_mpi_torch.pointtopoint.Request` completion
    protocol (``test``/``wait``/``active``/``cancel``), so Wait/Test/
    Waitall/Testall/Waitany/Testany/Waitsome/Testsome accept mixed lists
    of P2P and collective requests. ``result`` carries the allocating
    variant's return value after completion; errors raised inside the
    collective (mismatch, abort, deadlock) re-raise on Wait/Test.

    MPI contract (caller's side): do not touch the operation's buffers
    between initiation and completion, and initiate collectives on a
    communicator in the same order on every rank.
    """

    def __init__(self, future):
        self._future = future
        self.result = None
        self.status = None
        self._done = False
        self._inactive = False
        self.kind = "coll"
        self.buffer = None
        self.comm_cid = None     # pvar wait attribution (set by _nb_submit)
        # in-flight chunk state (overlap engine) — set by _nb_submit, advanced
        # by the progress worker, readable any time from the caller's thread
        self.progress = None

    def _complete(self) -> None:
        self.result = self._future.result()   # re-raises collective errors
        from .pointtopoint import STATUS_EMPTY
        self.status = STATUS_EMPTY
        self._done = True

    def test(self) -> bool:
        if self._done:
            return True
        if not self._future.done():
            return False
        self._complete()
        return True

    def wait(self):
        from .pointtopoint import STATUS_EMPTY
        if self._inactive:
            return self.status or STATUS_EMPTY
        if not self._done:
            # wait_owned(): an outer owner (PersistentCollRequest) already
            # accounts this round's wall clock — adding wait_ns here too
            # would double-count it (the outermost-owner rule).
            if _pv.enabled() and not _pv.wait_owned():
                t0 = _pv.monotonic()
                try:
                    self._complete()
                finally:
                    _pv.add_wait(_pv.monotonic() - t0, cid=self.comm_cid)
            else:
                self._complete()
        return self._consume()

    def _consume(self):
        """Surface the completion (Wait/Test-family contract): go inactive
        like a consumed P2P request; ``result`` stays readable."""
        from .pointtopoint import STATUS_EMPTY
        self._inactive = True
        return self.status or STATUS_EMPTY

    @property
    def active(self) -> bool:
        return not self._inactive

    def cancel(self) -> None:
        raise MPIError("nonblocking collectives cannot be cancelled")

    def __repr__(self) -> str:
        return f"<CollRequest done={self._done}>"


class _NbState:
    """Per-(comm, rank) nonblocking-collective worker: a single thread, so
    this rank's collectives INITIATE on the rendezvous in submission order,
    plus an outstanding counter that lets blocking collectives detect
    in-flight nonblocking ones and route through the same worker (ordering
    would otherwise race — an MPI-legal ``Ibarrier; Bcast; Wait`` could
    initiate in different orders on different ranks)."""

    def __init__(self, world_rank: int):
        from concurrent.futures import ThreadPoolExecutor
        self.executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"tpu-mpi-nbcoll-{world_rank}")
        self.outstanding = 0
        self.lock = threading.Lock()
        # submission id -> op name, insertion-ordered: names the in-flight
        # ops for diagnostics (Comm.free on a busy comm, lease reclamation)
        self._seq = 0
        self._pending: dict[int, str] = {}

    def submit(self, fn, opname: str = "collective"):
        with self.lock:
            self.outstanding += 1
            self._seq += 1
            sid = self._seq
            self._pending[sid] = (opname, None)
        fut = self.executor.submit(fn)
        with self.lock:
            if sid in self._pending:        # done() may already have pruned
                self._pending[sid] = (opname, fut)

        def done(_):
            with self.lock:
                self.outstanding -= 1
                self._pending.pop(sid, None)

        fut.add_done_callback(done)
        return fut

    def pending_ops(self) -> list:
        """Names of the submissions not yet completed, oldest first. A
        future can complete (its waiter unblocks) a beat before its done
        callback prunes the table, so consult the future itself — a
        ``Wait(); free()`` sequence must never see a phantom pending op."""
        with self.lock:
            return [name for name, fut in self._pending.values()
                    if fut is None or not fut.done()]

    def shutdown(self) -> None:
        self.executor.shutdown(wait=False)


_nb_worker_tls = threading.local()    # True on a collective worker thread


def _nb_state(ctx, cid, world_rank, create: bool):
    key = ("nbcoll", cid, world_rank)
    with ctx.objects_lock:
        st = ctx.objects.get(key)
        if st is None and create:
            st = _NbState(world_rank)
            ctx.objects[key] = st
        return st


def nb_pending(ctx, cid, world_rank) -> list:
    """Names of this rank's in-flight nonblocking collectives on one comm
    (empty when the worker is idle or was never created). Consulted by
    ``Comm.free`` so freeing under in-flight ops is a typed error naming
    the offenders instead of a strict-mode-only leak assert."""
    st = _nb_state(ctx, cid, world_rank, create=False)
    return st.pending_ops() if st is not None else []


def nb_shutdown(ctx, cid=None, world_rank=None) -> None:
    """Release nonblocking-collective workers: the ones of one comm+rank
    (Comm.free) or every one owned by a rank (Finalize)."""
    with ctx.objects_lock:
        keys = [k for k in ctx.objects
                if isinstance(k, tuple) and k and k[0] == "nbcoll"
                and (cid is None or k[1] == cid)
                and (world_rank is None or k[2] == world_rank)]
        states = [ctx.objects.pop(k) for k in keys]
    for st in states:
        st.shutdown()


def _nb_submit(comm: Comm, fn, opname: str = "collective") -> CollRequest:
    """Run ``fn`` on this rank's per-comm collective worker (the host-path
    progress engine: the worker thread advances the collective — including
    its pipeline chunks — while the caller is in user code; the request's
    ``progress`` exposes the in-flight chunk state)."""
    from ._runtime import require_env, set_env
    from .overlap import ChunkProgress, bind_progress, demote_fast_armed

    # a fast-armed persistent round on this comm has not rendezvoused yet:
    # it must initiate (on the worker) BEFORE this submission to keep the
    # per-comm initiation order equal to program order
    demote_fast_armed(comm.cid)
    ctx, world_rank = require_env()
    st = _nb_state(ctx, comm.cid, world_rank, create=True)
    prog = ChunkProgress()

    def run():
        # the worker impersonates the initiating rank (thread-tier ranks
        # are TLS-bound; the proc tier's process-global binding also works)
        set_env((ctx, world_rank))
        _nb_worker_tls.active = True
        bind_progress(prog)
        prog.stage = "running"
        try:
            return fn()
        finally:
            prog.stage = "done"
            bind_progress(None)
            _nb_worker_tls.active = False
            set_env(None)

    req = CollRequest(st.submit(run, opname=opname))
    req.progress = prog
    req.comm_cid = comm.cid       # attributes the caller's Wait time (pvars)
    return req


def _ordered_run(comm: Comm, call):
    """Initiation-order guard for BLOCKING collectives: when this rank's
    nonblocking worker has outstanding work on this comm, run the blocking
    collective THROUGH the worker (submission order = program order) and
    wait; otherwise call directly. Without this, an MPI-legal
    ``Ibarrier(comm); Bcast(buf, 0, comm); Wait(req)`` could initiate in
    different orders on different ranks and mispair rendezvous rounds."""
    if getattr(_nb_worker_tls, "active", False):
        return call()                      # already ON the worker
    # fast-armed persistent rounds initiate before this blocking collective
    # (same program-order rule as the worker submissions)
    from .overlap import demote_fast_armed
    demote_fast_armed(comm.cid)
    from ._runtime import current_env
    env = current_env()
    if env is None:
        return call()
    ctx, world_rank = env
    st = _nb_state(ctx, comm.cid, world_rank, create=False)
    if st is None or st.outstanding == 0:
        # an idle worker has fully completed everything it initiated, so a
        # direct call cannot overtake anything (and a CONCURRENT submitter
        # from another user thread is the user's ordering responsibility,
        # exactly as in MPI THREAD_MULTIPLE)
        return call()
    from ._runtime import set_env

    def run():
        set_env((ctx, world_rank))
        _nb_worker_tls.active = True
        try:
            return call()
        finally:
            _nb_worker_tls.active = False
            set_env(None)

    return st.submit(run).result()


def Ibarrier(comm: Comm) -> CollRequest:
    """Nonblocking barrier: complete once every rank has entered."""
    return _nb_submit(comm, lambda: Barrier(comm), opname="Ibarrier")


def Ibcast(buf: Any, root: int, comm: Comm) -> CollRequest:
    """Nonblocking Bcast; ``req.result`` is the (mutated) buffer."""
    return _nb_submit(comm, lambda: Bcast(buf, root, comm), opname="Ibcast")


def Iallreduce(*args) -> CollRequest:
    """Nonblocking Allreduce (same flavors as :func:`Allreduce`); the
    allocating variant's value arrives in ``req.result``."""
    return _nb_submit(_comm_of(args), lambda: Allreduce(*args),
                      opname="Iallreduce")


def Ireduce(*args) -> CollRequest:
    """Nonblocking rooted Reduce."""
    return _nb_submit(_comm_of(args), lambda: Reduce(*args), opname="Ireduce")


def Igather(*args) -> CollRequest:
    """Nonblocking rooted Gather."""
    return _nb_submit(_comm_of(args), lambda: Gather(*args), opname="Igather")


def Iallgather(*args) -> CollRequest:
    """Nonblocking Allgather."""
    return _nb_submit(_comm_of(args), lambda: Allgather(*args),
                      opname="Iallgather")


def Iscatter(*args) -> CollRequest:
    """Nonblocking rooted Scatter."""
    return _nb_submit(_comm_of(args), lambda: Scatter(*args), opname="Iscatter")


def Ialltoall(*args) -> CollRequest:
    """Nonblocking Alltoall."""
    return _nb_submit(_comm_of(args), lambda: Alltoall(*args),
                      opname="Ialltoall")


def Iscan(*args) -> CollRequest:
    """Nonblocking inclusive Scan."""
    return _nb_submit(_comm_of(args), lambda: Scan(*args), opname="Iscan")


def Iexscan(*args) -> CollRequest:
    """Nonblocking exclusive Scan."""
    return _nb_submit(_comm_of(args), lambda: Exscan(*args), opname="Iexscan")


def _comm_of(args) -> Comm:
    if not args or not isinstance(args[-1], Comm):
        raise TypeError("the last argument must be the communicator")
    return args[-1]


# ---------------------------------------------------------------------------
# Persistent collectives (MPI-4 MPI_Allreduce_init family), mirroring the
# persistent P2P machinery (pointtopoint.Send_init/Recv_init + Prequest):
# the arguments bind once, every Start initiates one round on the progress
# worker, and the first round populates the plan cache so later rounds skip
# per-call setup entirely — the training-loop shape.
# ---------------------------------------------------------------------------

def _registered_device_fold(op: Op, count: int, dtype: Any, size: int,
                            device: torch.device, donate: bool = True):
    """The fold of the registered device lane, bound once at plan creation
    (counterpart of the JAX package's AOT-compiled donated fold). Every
    round folds the ranks' tensors with the fused kernel. With ``donate``,
    two preallocated accumulator slots alternate and the kernel writes the
    round's result into its slot in place (``out=``) — no per-round
    allocation — so round k's result stays valid until round k+2 reuses
    that slot: the persistent in-place contract documented in
    docs/performance.md. Without ``donate`` (the auto-armed lane's
    copy-out contract) every round's output is a fresh tensor.

    Returns the combine closure, or None when the kernel does not take
    this op and dtype (a custom callable included): the caller then
    declines the device registration and the generic path folds."""
    dt = dtype
    kop = _kernel_op(op, dt)
    if kop is None:
        return None
    count = int(count)
    ring = ([torch.empty(count, dtype=dt, device=device),
             torch.empty(count, dtype=dt, device=device)] if donate else None)
    state = {"k": 0}

    def combine(cs, rt=None):
        k = state["k"]
        state["k"] = k + 1
        n = len(cs)
        good = n == size and all(
            is_torch_tensor(c) and tuple(c.shape) == (count,) and c.dtype == dt
            and c.device == device and c.is_contiguous() for c in cs)
        if good:
            if not donate:
                return [_fused.fused_multi_reduce(cs, kop)] * n
            slot = ring[k & 1]
            # an operand overlapping the slot (a rank fed a previous result
            # straight back) must not be overwritten mid-fold: fold fresh
            if not any(_fused.overlaps(c, slot) for c in cs):
                return [_fused.fused_multi_reduce(cs, kop, out=slot)] * n
            return [_fused.fused_multi_reduce(cs, kop)] * n
        # a peer contributed a host / reshaped payload this round: generic
        total = _reduce_arrays(list(cs), op)
        return [total] * n

    return combine


def _register_allreduce(comm: Comm, args,
                        donate: bool = True) -> Optional[PlanRegistration]:
    """Build the registered-buffer fast path of one ``Allreduce_init``
    signature, or None when the operands are not
    eligible (every round then takes the generic worker path).

    ``donate=False`` selects the auto-arm copy-out contract:
    the allocating flavor returns a FRESH array every round instead of the
    plan-private registered result, and the device lane folds into a fresh
    tensor every round instead of its two slots — bitwise identical to the
    generic path with none of the R302 reuse hazard.
    Hand-armed ``Allreduce_init`` callers keep ``donate=True`` (documented
    persistent in-place result semantics).

    Everything a round needs is resolved and PINNED here, at plan-creation
    time:

    - the send operand's flat wire view (``buffers.pinned_wire_view``) —
      rendezvous ships the pre-bound view, no per-call normalization;
    - the fold accumulator (``buffers.register_scratch``) — the chunked
      in-place ufunc fold lands in plan-private pinned memory (the generic
      ``_chunked_fold`` allocates its output every call);
    - the copy-out target — the user's recv buffer's pinned view, or a
      per-rank registered result array for the allocating flavor
      (returned in place round after round: ``Allreduce_init`` callers opt
      into persistent in-place result semantics, see docs/performance.md);
    - on the device lane (thread tier), the kernel fold and its two
      accumulator slots (:func:`_registered_device_fold`), bound once per
      plan;
    - on the multi-process tier, the same-host shm segment lease
      (``ProcChannel.shm_bind``) so no round pays the lazy mmap.

    The round closure then does ONE rendezvous round trip inline on the
    calling thread — no arg parse, no plan lookup, no worker hop, zero
    steady-state allocation — with the thread tier's channel lock released
    during the fold (``unlocked_fold``: the combine only touches the
    plan-private scratch)."""
    from . import config
    from ._runtime import CollectiveChannel as _ThreadChannel, current_env
    from .buffers import pinned_wire_view, register_scratch

    if not isinstance(comm, Comm) or isinstance(comm, Intercomm):
        return None
    env = current_env()
    if env is None:
        return None                 # outside an SPMD env: legacy path raises
    ctx, world_rank = env
    cfg = config.load()
    if not cfg.registered_buffers:
        # knob off: keep a disabled stub so a later config reload (which
        # bumps GENERATION) re-runs this factory and can bind for real
        def _off():
            raise MPIError("registered fast path is disabled")
        return _registry.add(PlanRegistration(
            comm.cid, config.GENERATION, _off, knob_on=False))
    try:
        sendbuf, recvbuf, count, op, _root, _c, alloc = \
            _parse_reduce_args(args, False, "Allreduce")
    except Exception:
        return None                 # malformed args: legacy path raises
    inplace = isinstance(sendbuf, _InPlace)
    if inplace:
        if _is_none(recvbuf):
            return None
        sendbuf = recvbuf
    try:
        if count is None:
            count = element_count(sendbuf)
        assert_minlength(sendbuf, count)
    except Exception:
        return None
    count = int(count)
    size, rank = comm.size(), comm.rank()
    channel = comm.channel()
    thread_tier = isinstance(channel, _ThreadChannel)

    from .operators import is_elementwise
    sendview = pinned_wire_view(sendbuf, count)
    scratch: tuple
    if sendview is not None:
        # ---- host lane: pinned views + registered in-place chunk fold ----
        if op.ufunc is None or not is_elementwise(op):
            return None
        payload = sendview
        acc = register_scratch(count, sendview.dtype)
        contrib = lambda: sendview
        cplan = _reduce_plan(comm, "Allreduce", "reduce", op, count, payload)
        bounds = (tuple(cplan.schedule) if cplan.schedule is not None
                  else ((0, count),))
        shared = [acc] * size

        def combine(cs, rt=None):
            flats = []
            for c in cs:
                if isinstance(c, np.ndarray) and c.dtype == acc.dtype \
                        and c.size == count:
                    flats.append(c.reshape(-1))
                else:
                    # a peer contributed a device / promoted payload this
                    # round: fold generically, land it in the pinned scratch
                    total = _reduce_arrays(list(cs), op,
                                           schedule=cplan.schedule)
                    np.copyto(acc, np.asarray(total).reshape(-1),
                              casting="unsafe")
                    return shared
            for lo, hi in bounds:
                np.copyto(acc[lo:hi], flats[0][lo:hi])
                for f in flats[1:]:
                    op.ufunc(acc[lo:hi], f[lo:hi], out=acc[lo:hi])
            return shared

        if alloc:
            out = register_scratch(count, sendview.dtype)
            shape = np.shape(sendbuf)
            ret = out.reshape(shape) \
                if int(np.prod(shape, dtype=np.int64)) == count else out
            scratch = (acc, out)

            if donate:
                def copyout(res):
                    if res is not out:
                        np.copyto(out, np.asarray(res).reshape(-1),
                                  casting="unsafe")
                    return ret
            else:
                def copyout(res):
                    if res is not out:
                        np.copyto(out, np.asarray(res).reshape(-1),
                                  casting="unsafe")
                    return np.array(ret, copy=True)
        else:
            tgt = sendbuf if inplace else recvbuf
            tgtview = sendview if inplace else pinned_wire_view(tgt, count)
            if tgtview is None:
                return None         # unbindable recv operand: legacy path
            scratch = (acc,)

            def copyout(res):
                resarr = np.asarray(res).reshape(-1)
                if resarr is not tgtview and resarr.base is not tgtview:
                    np.copyto(tgtview, resarr, casting="unsafe")
                return tgt
    elif (isinstance(sendbuf, DeviceBuffer) or is_torch_tensor(sendbuf)) \
            and thread_tier:
        # ---- device lane: slot-ring kernel fold, thread tier only ----
        payload = wire_view(sendbuf, count)
        cplan = _reduce_plan(comm, "Allreduce", "reduce", op, count, payload)
        combine = _registered_device_fold(op, count, payload.dtype, size,
                                          payload.device, donate=donate)
        if combine is None:
            return None
        # rebind-aware zero-copy view: the fold's output never aliases an
        # operand, and every rank waits in the rendezvous until the fold is
        # launched on the shared stream
        contrib = lambda: wire_view(sendbuf, count)
        scratch = ()
        if alloc:
            shape = tuple(getattr(sendbuf, "shape", ()))
            reshape = int(np.prod(shape, dtype=np.int64)) == count
            wrap = isinstance(sendbuf, DeviceBuffer)

            def copyout(res):
                val = res if (not reshape or tuple(res.shape) == shape) \
                    else res.reshape(shape)
                return DeviceBuffer(val, device=val.device) if wrap else val
        else:
            tgt = sendbuf if inplace else recvbuf
            if not isinstance(tgt, DeviceBuffer):
                return None         # raw tensor recv: legacy path copies in
            def copyout(res):
                v = tgt.value
                if is_torch_tensor(res) and res.numel() == v.numel() \
                        and res.dtype == v.dtype and res.device == v.device:
                    tgt.setflat(res if res.shape == v.shape
                                else res.reshape(v.shape))
                else:
                    tgt.setflat(res, count)
                return tgt
    else:
        return None

    shm_release = None
    shm_bind = getattr(channel, "shm_bind", None)
    if shm_bind is not None:
        nbytes = int(count) * int(getattr(payload.dtype, "itemsize", 0) or 0)
        shm_release = shm_bind(nbytes)

    cid = comm.cid

    def nb_probe() -> int:
        st = _nb_state(ctx, cid, world_rank, create=False)
        return 0 if st is None else st.outstanding

    opname, hint, sig = cplan.opname, cplan.hint, cplan.sig
    runkw = {"unlocked_fold": True} if thread_tier else {}
    pkey = _payload_key(sig)
    pv_nbytes = _pv.payload_nbytes(payload)

    def run_round():
        # the fast-armed Wait: one rendezvous round trip on THIS thread.
        # _ordered_run is unnecessary by construction — arming required an
        # idle nonblocking worker, and any later submission on this comm
        # demotes the armed round before it gets here.
        sc = _pv.op_begin() if _pv.enabled() else None
        try:
            res = channel.run(rank, contrib(), combine, opname,
                              plan=hint, stamp=pkey, **runkw)
            if sc is None:
                return copyout(res)
            t0 = _pv.monotonic()
            val = copyout(res)
            sc.spans.append(("copy", t0, _pv.monotonic()))
            return val
        finally:
            if sc is not None:
                _pv.op_end(sc, comm, coll="allreduce", algo=sig.get("algo"),
                           dtype=sig.get("dtype"), nbytes=pv_nbytes)

    # batched-submission hook: the pieces Waitall needs to
    # deposit K armed rounds through ONE rendezvous wakeup on the thread
    # tier (CollectiveChannel.run_batch). Proc-tier batching happens a
    # layer down (framed "batchv" coalescing in ProcChannel), so only the
    # thread tier publishes the parts.
    round_parts = None
    if thread_tier:
        round_parts = {
            "channel": channel, "rank": rank, "contrib": contrib,
            "combine": combine, "opname": opname, "hint": hint,
            "runkw": runkw, "copyout": copyout, "comm": comm,
            "sig": sig, "pv_nbytes": pv_nbytes, "stamp": pkey,
        }

    return _registry.add(PlanRegistration(
        cid, config.GENERATION, run_round, scratch=scratch, wire=sendview,
        shm_release=shm_release, knob_on=True, nb_probe=nb_probe,
        inplace_optin=bool(inplace or (alloc and donate)),
        round_parts=round_parts))

def _persistent_round(req: PersistentCollRequest, fn):
    """Run one legacy-lane persistent round on the worker thread, under
    its round key (checked across ranks by the rendezvous), tagging
    the collective event it records with the owning handle + round so
    ``analyze.explore`` models the round's timing from the Start/Wait pair
    instead of double-counting the inner event."""
    from ._runtime import persistent_round
    from .analyze import events as _ev
    with persistent_round(req.round_key):
        if not _ev.enabled():
            return fn()
        with _ev.persistent_scope(id(req), req._round - 1):
            return fn()


def Allreduce_init(*args) -> PersistentCollRequest:
    """Persistent Allreduce (same flavors as :func:`Allreduce`). Arm with
    ``Start``/``Startall``; complete with the Wait/Test family; reuse. The
    allocating variant's value lands in ``req.result`` each round."""
    comm = _comm_of(args)
    req = PersistentCollRequest(
        lambda: _nb_submit(comm, lambda: _persistent_round(
            req, lambda: Allreduce(*args))),
        "pallreduce", args[0] if args else None, comm=comm)
    return req.bind_registration(lambda: _register_allreduce(comm, args))


def Bcast_init(buf: Any, root: int, comm: Comm) -> PersistentCollRequest:
    """Persistent Bcast of ``buf`` from ``root``; mutates buf every round."""
    req = PersistentCollRequest(
        lambda: _nb_submit(comm, lambda: _persistent_round(
            req, lambda: Bcast(buf, root, comm))),
        "pbcast", buf, comm=comm)
    return req


def Barrier_init(comm: Comm) -> PersistentCollRequest:
    """Persistent barrier."""
    req = PersistentCollRequest(
        lambda: _nb_submit(comm, lambda: _persistent_round(
            req, lambda: Barrier(comm))),
        "pbarrier", None, comm=comm)
    return req


