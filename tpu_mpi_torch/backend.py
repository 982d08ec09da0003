"""Multi-process backend: one OS process per rank over the native transport.

The scale-out tier (SURVEY.md §2.5 "distributed communication backend"):
where the default runtime executes ranks as threads of one controller
process, this backend runs each rank in its own process — the deployment
shape of ``mpiexec -n N`` — wired through the C++ framed transport in
``tpu_mpi_torch._native`` (the libmpi-analog progress engine, MPI.jl's deps
model: external native transport + in-language object model). The port of
the JAX package's module of the same name.

Tensors cross processes through the host, as the JAX package moves its
arrays: the sender makes one device-to-host copy into the transport frame
or the shm spill (:class:`_TensorLeaf`), the algorithm tiers fold and move
host numpy exactly as the JAX package's do (one counted copy of a tensor
payload in, :func:`_hostify`), and a result goes back to the caller's
device and dtype with one host-to-device copy (:func:`_from_host`). The
star tier's root unpacks the contributions onto its own device and folds
them with the collective's combine — on CUDA tensors, the fused fold
kernel. Every copy across the card's edge is counted in :data:`staging`.
Several rank processes on a one-card host share the card
(:meth:`ProcContext.device_for`).

Reused unchanged from the threaded runtime: the Mailbox matching engine
(tags/wildcards/probe), all of pointtopoint/collective/topology/io, and the
per-communicator collective protocol. What changes is the rendezvous: the
:class:`ProcChannel` gathers pickled contributions to the communicator's
rank-0 process, runs ``combine`` there, and scatters per-rank results —
the same "last arriver combines" contract, executed at a distinguished
process. One-sided windows work across processes via the RMA wire engine
(``tpu_mpi_torch._rma_wire``): owners apply Put/Get/Accumulate/lock frames shipped
by origins, and shared windows are real POSIX shared memory.

Launch: ``tpurun -n N --procs script.py``. The launcher is the rendezvous
server: children report their transport ports, receive the full address map,
then run the script.
"""

from __future__ import annotations

import itertools
import json
import os
import pickle
import socket
import struct
import sys
import threading
import time
import zlib
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from . import config
from . import perfvars as _pv
from . import serialization
from .buffers import _mark_wire_snapshot, is_wire_snapshot
from ._runtime import (ANY_SOURCE, FailureDetector, Mailbox, Message,
                       SpmdContext, _Waitable, collective_wait_limit,
                       deadlock_timeout, set_env, set_process_env)
from .error import (AbortError, CollectiveMismatchError, DeadlockError,
                    MPIError, ProcFailedError)

_POLL_MS = 50

# Below this payload size the star rendezvous wins on latency (2 hops vs
# 2(P-1) ring steps); above it the ring's O(bytes/P) per-process traffic wins.
_RING_MIN_BYTES = int(os.environ.get("TPU_MPI_RING_MIN_BYTES", str(64 * 1024)))


# ---------------------------------------------------------------------------
# Zero-copy wire encoding: pickle protocol 5 with out-of-band buffers.
# A frame is [magic][nbufs u32][skel_len u64][skeleton pickle]
# [flag u8 + len u64 + body]*. Array payloads (numpy, and tensors via _TensorLeaf)
# travel out of band — no pickle byte-copy — by one of two lanes per buffer:
#
# - flag 0 (inline): raw buffer bytes in the TCP stream, decoded as zero-copy
#   views into the received frame (the reference gets this from libmpi's
#   typed transport);
# - flag 1 (shm): for large buffers bound for a SAME-HOST rank, the body is
#   just the name of a one-shot POSIX shm segment holding the bytes — the
#   libmpi shared-memory-BTL analog. The sender writes the segment (tmpfs:
#   one memcpy), the receiver maps it, unlinks it immediately (the mapping
#   keeps it alive) and decodes arrays as views straight into the mapping, so
#   the payload never crosses a socket and is copied exactly once end to end.
#   The launcher sweeps any segments orphaned by a crashed rank.
# ---------------------------------------------------------------------------

_OOB_MAGIC = b"\x01TMB6"
_STAR = object()     # "no algorithm applies; use the generic star rendezvous"

_SHM_DIR = "/dev/shm"
_shm_counter = itertools.count()


_shm_min_cached: Optional[int] = None


def _shm_min_bytes() -> int:
    """Payload threshold for the shm lane; 0 (or a missing /dev/shm)
    disables. Resolved once — this sits on the per-message send path, and
    neither the config nor /dev/shm's existence changes mid-job."""
    global _shm_min_cached
    if _shm_min_cached is None:
        _shm_min_cached = (config.load().shm_min_bytes
                           if os.path.isdir(_SHM_DIR) else 0)
    return _shm_min_cached


def shm_job_tag() -> str:
    """Per-job namespace for shm segment names (the coordinator port is
    shared by every rank of a job and by the launcher, which sweeps
    ``tpumpi_<tag>_*`` leftovers after the job ends). Comm_spawn'ed children
    inherit the job tag via TPU_MPI_SHM_TAG — their PROC_COORD points at an
    ephemeral spawn coordinator nothing would ever sweep."""
    tag = os.environ.get("TPU_MPI_SHM_TAG")
    if tag:
        return tag
    coord = os.environ.get("TPU_MPI_PROC_COORD", "")
    return coord.rsplit(":", 1)[-1] or "local"


def _shm_spill(mv: memoryview) -> bytes:
    """Write a buffer into a fresh one-shot shm segment; return its name."""
    name = f"tpumpi_{shm_job_tag()}_{os.getpid()}_{next(_shm_counter)}"
    path = os.path.join(_SHM_DIR, name)
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
    try:
        view = mv.cast("B")
        off = 0
        while off < view.nbytes:
            off += os.write(fd, view[off:])
    except BaseException:
        os.close(fd)
        try:                       # don't leave a partial segment pinning RAM
            os.unlink(path)
        except OSError:
            pass
        raise
    os.close(fd)
    return name.encode()


def sweep_segments(tag: str, only_dead_creators: bool = False) -> None:
    """Unlink shm-lane segments for a job tag. The launcher calls this after
    every child has exited (a clean run leaves nothing — receivers unlink at
    load time); ranks launched by an external scheduler call it with
    ``only_dead_creators=True`` at attach, reclaiming segments whose creating
    process (the pid embedded in the name) is gone."""
    import glob
    for seg in glob.glob(os.path.join(_SHM_DIR, f"tpumpi_{tag}_*")):
        if only_dead_creators:
            try:
                pid = int(os.path.basename(seg).split("_")[2])
            except (IndexError, ValueError):
                continue
            if os.path.exists(f"/proc/{pid}"):
                continue
        try:
            os.unlink(seg)
        except OSError:
            pass


def _shm_load(name: str) -> memoryview:
    """Map a one-shot segment and unlink it; the returned view (and any
    arrays decoded over it) keeps the mapping alive until GC."""
    import mmap as _mmap
    path = os.path.join(_SHM_DIR, name)
    fd = os.open(path, os.O_RDWR)
    try:
        os.unlink(path)
        size = os.fstat(fd).st_size
        m = _mmap.mmap(fd, size)
    finally:
        os.close(fd)
    return memoryview(m)


def dumps_oob_parts(item: Any, shm_ok: bool = False) -> list:
    """Encode as a list of wire segments (header/skeleton bytes + raw array
    buffers). Sent with ``transport.sendv`` so array payloads go from their
    own memory straight to the socket — no join copy. With ``shm_ok`` (the
    destination shares this host), large buffers take the shm lane instead."""
    bufs: list[pickle.PickleBuffer] = []
    # extended pickler: closures/local classes inside frames (spawn
    # commands, custom ops, object payloads) travel by value cross-process
    skel = serialization.dumps_oob(item, buffer_callback=bufs.append)
    parts = [_OOB_MAGIC + struct.pack("<IQ", len(bufs), len(skel)), skel]
    shm_min = _shm_min_bytes() if shm_ok else 0
    for pb in bufs:
        mv = pb.raw()
        if not mv.c_contiguous:
            mv = memoryview(bytes(mv))
        if shm_min and mv.nbytes >= shm_min:
            name = _shm_spill(mv)
            parts.append(struct.pack("<BQ", 1, len(name)))
            parts.append(name)
        else:
            parts.append(struct.pack("<BQ", 0, mv.nbytes))
            parts.append(mv.cast("B"))
    return parts


def dumps_oob(item: Any) -> bytes:
    return b"".join(dumps_oob_parts(item))


def send_frame(transport, world_dst: int, item: Any,
               shm_ok: bool = False) -> None:
    """Encode + send a protocol frame with scatter-gather zero-copy."""
    transport.sendv(world_dst, dumps_oob_parts(item, shm_ok=shm_ok))


def loads_oob(frame: bytes) -> Any:
    if frame[:len(_OOB_MAGIC)] != _OOB_MAGIC:
        return pickle.loads(frame)       # legacy/plain frames (abort, …)
    mv = memoryview(frame)
    off = len(_OOB_MAGIC)
    nbufs, skel_len = struct.unpack_from("<IQ", frame, off)
    off += 12
    skel = mv[off:off + skel_len]
    off += skel_len
    bufs = []
    for _ in range(nbufs):
        flag, ln = struct.unpack_from("<BQ", frame, off)
        off += 9
        if flag == 1:
            bufs.append(_shm_load(bytes(mv[off:off + ln]).decode()))
        else:
            bufs.append(mv[off:off + ln])
        off += ln
    return pickle.loads(skel, buffers=bufs)


# ---------------------------------------------------------------------------
# Tensors through the host. numpy has no bfloat16 here, so a bfloat16
# tensor crosses as its raw bits in a uint16 array (as checkpoint.py writes
# it) and is viewed back on arrival.
# ---------------------------------------------------------------------------

# Copies across the card's edge made by this process's wire and algorithm
# tiers: counts, bytes and host-clock seconds per direction. Both copies are
# synchronous (pageable host memory), so the host clock spans the transfer.
staging = {"d2h": 0, "h2d": 0, "d2h_bytes": 0, "h2d_bytes": 0,
           "d2h_s": 0.0, "h2d_s": 0.0}
_staging_lock = threading.Lock()

def _note_staging(kind: str, t0: float, nbytes: int) -> None:
    dt = time.perf_counter() - t0
    with _staging_lock:
        staging[kind] += 1
        staging[kind + "_bytes"] += int(nbytes)
        staging[kind + "_s"] += dt


def reset_staging() -> None:
    with _staging_lock:
        for k in staging:
            staging[k] = 0.0 if k.endswith("_s") else 0


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's elements as a host numpy array: one counted copy off the
    card for a CUDA tensor, a view of a CPU tensor (bfloat16 as its uint16
    bits). A copy off the card, or a view of a private wire snapshot, is
    marked as a wire snapshot, so the ring may fold into it in place."""
    src = t.detach()
    if src.device.type != "cpu":
        t0 = time.perf_counter()
        h = src.cpu()
        _note_staging("d2h", t0, h.numel() * h.element_size())
        private = True
    else:
        h = src
        private = is_wire_snapshot(t)
    arr = (h.view(torch.int16).numpy().view(np.uint16)
           if h.dtype == torch.bfloat16 else h.numpy())
    return _mark_wire_snapshot(arr) if private else arr


def _viewable(a: np.ndarray) -> np.ndarray:
    """``a``, or a copy of it where torch cannot view it: a read-only or
    non-contiguous array, or one whose elements do not start at a multiple
    of their size. A frame's payload starts wherever its header ends, and
    torch loads a complex128 as 16 aligned bytes (a misaligned one faults)."""
    if (a.flags.c_contiguous and a.flags.writeable
            and a.ctypes.data % a.dtype.itemsize == 0):
        return a
    return np.array(a, copy=True)


def _to_tensor(arr: Any, dtype: torch.dtype, device: Any) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``device``: a view of a
    writeable, aligned array on the CPU, one counted host-to-device copy on
    CUDA."""
    a = _viewable(np.asarray(arr))
    if dtype == torch.bfloat16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
        if t.dtype != dtype:
            t = t.to(dtype)
    if torch.device(device).type == "cpu":
        return t
    t0 = time.perf_counter()
    out = t.to(device)
    _note_staging("h2d", t0, out.numel() * out.element_size())
    return out


def _bits_as_bf16(a: Any) -> torch.Tensor:
    """bfloat16 elements held as their uint16 bits, as a CPU tensor."""
    a = _viewable(np.asarray(a))
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def _bf16_as_bits(t: Any) -> Any:
    """A CPU bfloat16 tensor's elements as uint16 bits (other values as
    they are)."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t


class _Bf16Op:
    """``op`` over bfloat16 elements that an array runner holds on the host
    as uint16 bits: each step folds them as CPU bfloat16 tensors — a
    float32 op rounded to bfloat16 at every step, as the JAX package's
    host tiers fold ml_dtypes bfloat16 arrays."""

    ufunc = None

    def __init__(self, op: Any):
        self.op = op
        self.commutative = getattr(op, "commutative", False)
        self.name = getattr(op, "name", "custom")

    def __call__(self, a: Any, b: Any) -> np.ndarray:
        return _bf16_as_bits(self.op(_bits_as_bf16(a), _bits_as_bf16(b)))


def _bf16_combine(combine: Callable) -> Callable:
    """The star's ``combine`` over contributions held as bfloat16 bits: the
    shm root's rank-ordered slot views fold as CPU bfloat16 tensors."""
    def run(cs: list) -> list:
        return [_bf16_as_bits(r)
                for r in combine([_bits_as_bf16(c) for c in cs])]
    return run


def _is_bf16(contrib: Any) -> bool:
    return isinstance(contrib, torch.Tensor) and contrib.dtype == torch.bfloat16


def _hostify(contrib: Any) -> tuple[Any, Optional[torch.Tensor]]:
    """``(host payload, the tensor it came from or None)`` for an array
    runner: a tensor contribution (or the wire half of an Alltoallv's
    ``(wire, counts)``) becomes host numpy in one counted copy."""
    if isinstance(contrib, torch.Tensor):
        return _host_array(contrib), contrib
    if (isinstance(contrib, tuple) and contrib
            and isinstance(contrib[0], torch.Tensor)):
        return (_host_array(contrib[0]),) + contrib[1:], contrib[0]
    return contrib, None


def _from_host(result: Any, like: Optional[torch.Tensor]) -> Any:
    """An array runner's host result back to the contribution's kind: a
    tensor of its dtype on its device (one counted copy onto a card)."""
    if like is None or not isinstance(result, np.ndarray):
        return result
    return _to_tensor(result, like.dtype, like.device)


# ---------------------------------------------------------------------------
# Binary P2P fast lane (small-message latency is otherwise dominated by
# pickle-protocol-5 framing of a 9-tuple per message). Typed
# numpy payloads with simple dtypes — the OSU-style hot path — skip pickle
# entirely: a fixed struct header + dtype tag + raw payload bytes. Complex
# cases (structured dtypes, shm-lane-sized frames, arbitrary
# objects) keep the generic OOB pickle codec.
# ---------------------------------------------------------------------------

_FAST_MAGIC = b"\x02TMP"
# magic, src, tag, cid-form (0: plain int in c1 | 1: the proc-tier tuple
# ("c", rank, counter) in (c1, c2)), c1, c2, count, seq (-1 = unstamped),
# kind (0 typed / 1 object-bytes), dtype tag length. The magic is part of
# the struct so the header packs in ONE call (no bytes concat per message).
_FAST_HDR = struct.Struct("<4siiBqqqqBB")
_FAST_JOIN_MAX = 8192        # below this, join into ONE buffer: a single
                             # FFI call + write beats per-part view setup
                             # (matches the transport's single-recv window)

_fast_dt_tag: dict = {}      # np.dtype -> tag bytes (send side)
_fast_dt_cache: dict = {}    # tag bytes -> (np.dtype, Datatype) (recv side)


def _fast_p2p_parts(msg: Message, seq: Optional[int]) -> Optional[list]:
    """Encode a P2P message on the fast lane, or None if ineligible. A
    tensor travels as its host bytes (a view of a CPU tensor, one counted
    copy off the card) tagged with its torch dtype and its device kind
    (kinds 2 and 3)."""
    payload = msg.payload
    if msg.kind == "typed" and isinstance(payload, torch.Tensor):
        dt = str(payload.dtype).encode()          # b"torch.float32"
        kind = 3 if payload.device.type == "cuda" else 2
        payload = _host_array(payload.contiguous())
    elif msg.kind == "typed" and isinstance(payload, np.ndarray):
        dt = _fast_dt_tag.get(payload.dtype)
        if dt is None:
            if payload.dtype.names is not None or payload.dtype.hasobject:
                return None      # structured/object dtypes: .str is lossy
            dt = payload.dtype.str.encode()
            _fast_dt_tag[payload.dtype] = dt
        if not payload.flags.c_contiguous:
            payload = np.ascontiguousarray(payload)
        kind = 0
    elif msg.kind == "object" and isinstance(payload, (bytes, bytearray)):
        dt = b""
        kind = 1
    else:
        return None
    if len(dt) > 255:
        return None
    cid = msg.cid
    if isinstance(cid, int):
        cform, c1, c2 = 0, cid, 0
    elif (isinstance(cid, tuple) and len(cid) == 3 and cid[0] == "c"
          and isinstance(cid[1], int) and isinstance(cid[2], int)):
        # the multi-process tier's process-namespaced context ids
        # (ProcContext.alloc_cid: ("c", world rank, counter))
        cform, c1, c2 = 1, cid[1], cid[2]
    else:
        return None
    hdr = _FAST_HDR.pack(_FAST_MAGIC, msg.src, msg.tag, cform, c1, c2,
                         msg.count, -1 if seq is None else seq, kind,
                         len(dt)) + dt
    if kind != 1:
        nbytes = payload.nbytes
        if nbytes <= _FAST_JOIN_MAX:
            return [hdr + payload.tobytes()]
        return [hdr, payload]
    if len(payload) <= _FAST_JOIN_MAX:
        return [hdr + payload]
    return [hdr, payload]


def _fast_p2p_decode(frame, ctx: "ProcContext") -> Optional[Message]:
    """Decode a fast-lane frame (memoryview) into a Message, or None; a
    tensor lands on ``ctx``'s card when it left a card."""
    if frame[:4] != _FAST_MAGIC:     # memoryview == bytes: no copy
        return None
    (_, src, tag, cform, c1, c2, count, seq, kind,
     dtlen) = _FAST_HDR.unpack_from(frame, 0)
    cid = c1 if cform == 0 else ("c", c1, c2)
    off = _FAST_HDR.size
    if kind in (2, 3):
        tdt = getattr(torch, bytes(frame[off:off + dtlen]).decode()[6:])
        np_dt = _tensor_np_dtype(tdt)
        host = np.frombuffer(frame[off + dtlen:], dtype=np_dt,
                             count=count)
        payload = _to_tensor(host, tdt,
                             ctx.card() if kind == 3 else "cpu")
        from .datatypes import to_datatype
        return Message(src, tag, cid, payload, count, to_datatype(tdt),
                       "typed", seq=None if seq < 0 else seq)
    if kind == 0:
        dts = bytes(frame[off:off + dtlen])
        cached = _fast_dt_cache.get(dts)
        if cached is None:
            from .datatypes import to_datatype
            np_dt = np.dtype(dts.decode())
            cached = (np_dt, to_datatype(np_dt))
            _fast_dt_cache[dts] = cached
        np_dt, dtype = cached
        payload = np.frombuffer(frame[off + dtlen:], dtype=np_dt,
                                count=count)
        return Message(src, tag, cid, payload, count, dtype, "typed",
                       seq=None if seq < 0 else seq)
    payload = bytes(frame[off:])
    return Message(src, tag, cid, payload, count, None, "object",
                   seq=None if seq < 0 else seq)


_np_of_torch: dict = {}


def _tensor_np_dtype(tdt: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``tdt`` crosses the host as."""
    dt = _np_of_torch.get(tdt)
    if dt is None:
        dt = (np.dtype(np.uint16) if tdt == torch.bfloat16
              else torch.empty(0, dtype=tdt).numpy().dtype)
        _np_of_torch[tdt] = dt
    return dt


class _TensorLeaf:
    """Pickle surrogate for a tensor: its elements as a host array (one
    device-to-host copy for a CUDA tensor; bfloat16 as uint16 bits), its
    torch dtype by name and whether it lived on CUDA. Device placement is
    per process: :meth:`restore` puts it on this process's card, or on the
    CPU where it came from the CPU."""

    __slots__ = ("value", "dtype", "cuda")

    def __init__(self, t: torch.Tensor):
        self.value = _host_array(t)
        self.dtype = str(t.dtype)[6:]
        self.cuda = t.device.type == "cuda"

    def restore(self, ctx: Optional["ProcContext"]) -> torch.Tensor:
        return _to_tensor(self.value, getattr(torch, self.dtype),
                          ctx.card() if self.cuda and ctx else "cpu")


def _pack(obj: Any) -> Any:
    """Recursively replace tensors with host surrogates for the wire."""
    if isinstance(obj, torch.Tensor):
        return _TensorLeaf(obj)
    if isinstance(obj, tuple):
        return tuple(_pack(o) for o in obj)
    if isinstance(obj, list):
        return [_pack(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    return obj


def _unpack(obj: Any, ctx: Optional["ProcContext"]) -> Any:
    """Put surrogates back as tensors: on ``ctx``'s card where they came
    from a card, or — ``ctx`` None — all on the CPU (RMA frames, which the
    owner writes into its window where the window lives)."""
    if isinstance(obj, _TensorLeaf):
        return obj.restore(ctx)
    if isinstance(obj, tuple):
        return tuple(_unpack(o, ctx) for o in obj)
    if isinstance(obj, list):
        return [_unpack(o, ctx) for o in obj]
    if isinstance(obj, dict):
        return {k: _unpack(v, ctx) for k, v in obj.items()}
    return obj


class _RemoteMailbox:
    """Sender-side proxy: post() ships the Message to the owning process.

    Flow control (the cross-process half of the blocking-send backpressure):
    a receiver whose unexpected queue crosses the high-water mark sends a
    ``choke`` frame; ``post_blocking`` waits while this destination has us
    choked, resuming on its ``unchoke``. Buffered Isend traffic is exempt,
    mirroring the thread tier."""

    def __init__(self, ctx: "ProcContext", world_rank: int):
        self.ctx = ctx
        self.world_rank = world_rank

    def post_blocking(self, msg: Message, what: str) -> None:
        ctx = self.ctx
        # Lock-free peek (hot path): choked_by only has entries while this
        # destination is over its high-water mark. Missing a just-added
        # choke lets at most one extra message through — backpressure is a
        # sustained-imbalance mechanism, not an exact credit count.
        if self.world_rank in ctx.choked_by:
            from ._runtime import deadlock_timeout
            deadline = time.monotonic() + deadlock_timeout()
            with ctx._choke_cond:
                while self.world_rank in ctx.choked_by:
                    ctx.check_failure()
                    if self.world_rank in ctx.failed_ranks:
                        raise ProcFailedError(
                            f"rank {self.world_rank} died while it had this "
                            f"sender choked ({what})",
                            ranks=(self.world_rank,))
                    if time.monotonic() > deadline:
                        raise DeadlockError(
                            f"deadlock suspected: rank {self.world_rank} kept "
                            f"this sender choked >{deadlock_timeout()}s in {what}")
                    ctx._choke_cond.wait(0.02)
        self.post(msg)

    def post(self, msg: Message) -> None:
        if msg.kind == "objref":
            raise MPIError(
                "cannot send an unpicklable object to another process; "
                "multi-process ranks do not share an address space")
        if self.ctx.debug_seq:
            # Stamp AND ship under one lock: a concurrent sender thread that
            # stamped first must also hit the wire first, or the receiver's
            # monotonic check would flag legal THREAD_MULTIPLE interleavings.
            # Serializing sends per process is an acceptable debug-mode cost.
            with self.ctx._seq_lock:
                seq = self.ctx._seq_counters.get(
                    (self.world_rank, msg.cid, msg.src), 0) + 1
                self.ctx._seq_counters[(self.world_rank, msg.cid, msg.src)] = seq
                self._ship(msg, seq)
            return
        self._ship(msg, None)

    def _ship(self, msg: Message, seq: Optional[int]) -> None:
        ctx = self.ctx
        # fast lane: pickle-free binary frame for typed/bytes payloads,
        # unless the payload should ride the shm lane instead (large +
        # same-host — the generic codec handles the spill)
        nbytes = getattr(msg.payload, "nbytes", None)
        # cheapest test first: small payloads (the latency path) resolve the
        # whole predicate on the threshold compare alone
        shm_wins = (nbytes is not None and (m := _shm_min_bytes())
                    and nbytes >= m and ctx.shm_ok(self.world_rank))
        parts = None
        if not shm_wins:
            try:
                parts = _fast_p2p_parts(msg, seq)
            except Exception:
                # any unexpected shape falls back to the generic codec —
                # an encode hiccup must never poison the job (found live:
                # tuple cids from sub-communicators)
                parts = None
        try:
            if parts is not None:
                if len(parts) == 1:
                    ctx.transport.send(self.world_rank, parts[0])
                else:
                    ctx.transport.sendv(self.world_rank, parts)
                return
            ctx.send_frame(self.world_rank,
                           ("p2p", msg.src, msg.tag, msg.cid,
                            _pack(msg.payload), msg.count, msg.dtype,
                            msg.kind, seq))
        except ConnectionError:
            if ctx._detector is None:
                raise
            # typed ULFM error for a send to a dead peer (detector active)
            ctx.peer_failed(self.world_rank)
            raise ProcFailedError(
                f"rank {self.world_rank} died before this send completed",
                ranks=(self.world_rank,)) from None

    def notify(self) -> None:  # failure broadcast reaches processes via abort
        pass


class _ShmColl:
    """One mmap'd /dev/shm segment shared by every rank of a same-host
    communicator — the libmpi ``coll/sm`` analog, and the latency tier the
    tuned table selects for small Allreduce/Barrier on single-host jobs.

    Layout: (n+1) cache-line header slots (seq, nbytes, ophash, dthash)
    followed by (n+1) data slots of ``coll_shm_max_bytes`` each; slot i
    belongs to comm rank i, slot n is the fold rank's result. The round
    protocol is a seqlock in one direction only: a writer publishes data
    first and its monotonically-increasing seq word LAST, readers spin for
    the exact seq value of their round (``rnd + 1``). The channel round
    counter and the run()-side blocking make slot reuse safe: a rank can
    only overwrite its contribution slot after it consumed the previous
    round's result, which the fold rank publishes only after consuming
    every previous contribution.

    Every rank opens the segment with O_CREAT (idempotent create +
    ftruncate), and the fold rank unlinks the path after its FIRST complete
    contribution gather — by then every rank has provably mapped the same
    inode, so the name is dead weight (the mappings keep it alive) and a
    crashed job leaves at most one transient name for the launcher sweep.
    A seq word ever observed ABOVE the expected round is a protocol error
    (stale segment from a previous job reusing the tag, or divergent
    configs) and fails loudly instead of hanging.
    """

    SLOT = 64                              # one cache line per header
    HDR = struct.Struct("<qqII")           # seq, nbytes, ophash, dthash

    def __init__(self, ctx: "ProcContext", cid: Any, group: tuple):
        import mmap as _mmap
        self.ctx = ctx
        self.cid = cid
        self.n = n = len(group)
        self.cap = max(int(config.load().coll_shm_max_bytes), 1)
        slug = ("-".join(str(p) for p in cid) if isinstance(cid, tuple)
                else str(cid))
        # non-numeric third name field: the external-scheduler
        # dead-creator sweep (which parses a pid there) skips these
        self.path = os.path.join(
            _SHM_DIR, f"tpumpi_{shm_job_tag()}_coll-{slug}")
        self.size = (n + 1) * (self.SLOT + self.cap)
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            st = os.fstat(fd)
            if st.st_size not in (0, self.size):
                raise MPIError(
                    f"shm collective segment {self.path} is {st.st_size} "
                    f"bytes, expected {self.size} — stale segment from a "
                    f"previous job sharing tag {shm_job_tag()!r}, or "
                    f"TPU_MPI_COLL_SHM_MAX_BYTES differs across ranks")
            os.ftruncate(fd, self.size)
            self.mm = _mmap.mmap(fd, self.size)
        finally:
            os.close(fd)
        self.unlinked = False
        # registered-plan slot leases (overlap.PlanRegistration.shm_release):
        # a persistent Allreduce pre-maps the segment at plan creation and
        # holds a lease until released; Comm.free asserts (strict mode) that
        # every lease was dropped before the mapping may be torn down
        self.leases = 0

    def _hdr(self, slot: int) -> int:
        return slot * self.SLOT

    def data_off(self, slot: int) -> int:
        return (self.n + 1) * self.SLOT + slot * self.cap

    def publish(self, slot: int, want: int, ophash: int, dthash: int,
                data) -> None:
        """Data first, header fields next, the seq word LAST (the readiness
        flag readers spin on; the GIL + x86 TSO order the stores)."""
        nb = 0
        if data is not None:
            nb = data.nbytes
            off = self.data_off(slot)
            self.mm[off:off + nb] = data
        h = self._hdr(slot)
        struct.pack_into("<qII", self.mm, h + 8, nb, ophash, dthash)
        struct.pack_into("<q", self.mm, h, want)

    def header(self, slot: int) -> tuple:
        return self.HDR.unpack_from(self.mm, self._hdr(slot))

    def spin(self, slot: int, want: int, opname: str) -> None:
        """Exact-value seq spin with escalating back-off (yield → sleep(0)
        → 200 us naps): on an oversubscribed host the other ranks need this
        core to make the progress being waited for."""
        limit = collective_wait_limit(opname) or deadlock_timeout()
        deadline = time.monotonic() + limit
        yield_ = getattr(os, "sched_yield", None)
        it = 0
        while True:
            v = struct.unpack_from("<q", self.mm, self._hdr(slot))[0]
            if v == want:
                return
            if v > want:
                err = MPIError(
                    f"shm collective protocol error in {opname!r}: slot "
                    f"{slot} seq {v} is past round {want} — stale segment "
                    f"from a previous job sharing tag {shm_job_tag()!r}?")
                self.ctx.fail(err)
                raise err
            self.ctx.check_failure()
            if self.ctx.failed_ranks or self.ctx.revoked_cids:
                self.ctx.check_fault(self.cid)   # dead peer / revoked comm
            it += 1
            if it < 200 and yield_ is not None:
                yield_()
            elif it < 2000:
                time.sleep(0)
            else:
                time.sleep(0.0002)
            if time.monotonic() > deadline:
                raise DeadlockError(
                    f"deadlock suspected: shm collective {opname!r} waited "
                    f">{limit:.0f}s on slot {slot} (round {want}); are all "
                    f"ranks in the same collective?")

    def maybe_unlink(self) -> None:
        if not self.unlinked:
            self.unlinked = True
            try:
                os.unlink(self.path)
            except OSError:
                pass


class ProcChannel(_Waitable):
    """Cross-process collective rendezvous for one communicator.

    Two tiers (the libmpi collective-algorithm analog, SURVEY.md §2.4 L0):

    - **Algorithm tier** for the hot collectives, selected by the ``plan``
      hint from ``tpu_mpi_torch.collective``: ring reduce-scatter + allgather for
      commutative Allreduce (O(bytes/P) per-process traffic instead of the
      star's O(P·bytes) root ingress), binomial-tree Bcast (log P depth),
      dissemination Barrier (log P rounds). Frames carry the opname and
      (for rooted ops) the claimed root, so mismatched collectives and
      divergent roots still fail loudly on all ranks.
    - **Chunked star tier** (overlap engine) for bulk elementwise Allreduce
      the ring declines (non-commutative op, or ring disabled): payloads
      above ``pipeline_min_bytes`` travel as K chunk frames; the root folds
      chunk k while its drainer still receives chunks k+1.. and ships each
      result chunk immediately — transfer overlaps fold, bitwise-equal to
      the monolithic star.
    - **Star tier** for everything else (arbitrary combine closures): ranks
      send (opname, contrib) to the comm's first process, which verifies,
      combines and scatters per-rank results. Rooted Gather/Scatter stay
      here deliberately — all bytes must land at / leave one process, so a
      tree only helps latency, not bandwidth.
    """

    def __init__(self, ctx: "ProcContext", cid: Any, group: tuple[int, ...]):
        self.ctx = ctx
        self.cid = cid
        self.group = group
        self.lock = threading.RLock()
        self.cond = threading.Condition(self.lock)
        self.round = 0
        # (round, comm_rank) -> (opname, contrib) at root;
        # (round,) -> result at non-root; ("alg", round, *tag) -> in-flight
        # algorithm-tier fragments. Fed by the drainer thread.
        self.inbox: dict[Any, Any] = {}
        # round -> (opname, "star"|"alg") while this process is inside run():
        # a frame for the same round arriving from a rank in a DIFFERENT
        # collective (other protocol tier) must fail loudly, not leave this
        # rank waiting for frames its tier will never see.
        self.inflight: dict[int, tuple[str, str]] = {}
        # rounds whose waiter is mid-busy-probe: pongs are stored only while
        # the round is here, so a pong racing the collres can't leak forever
        self.probing: set[int] = set()
        # lazily-mapped same-host shared-memory collective segment
        self._shm: Optional[_ShmColl] = None

    def _wait_for(self, pred, what, timeout=None, limit=None) -> bool:
        """Collective wait with blocked-receiver direct drain (extended
        to the collective rendezvous): the waiting rank thread
        pumps its own transport instead of depending on the drainer, which
        stays parked during and shortly after direct activity
        (_runtime.pump_wait, the shared loop)."""
        from ._runtime import pump_wait
        return pump_wait(self.ctx, self.cond, pred, what,
                         timeout=timeout, limit=limit, fault_cid=self.cid)

    def _mismatch(self, theirs: str, mine: str) -> None:
        """Record a cross-tier mismatch (drainer-side: fail, don't raise —
        blocked ranks surface it via check_failure)."""
        self.ctx.fail(CollectiveMismatchError(
            f"ranks disagree on the collective for cid {self.cid}: "
            f"{sorted({theirs, mine})}"))

    def _tier_mismatch(self, opname: str, who: Any) -> None:
        """Same collective, different algorithm tier — would hang silently
        (frames land in keys the other tier never waits on); fail loudly."""
        self.ctx.fail(CollectiveMismatchError(
            f"ranks disagree on the algorithm tier for {opname!r} "
            f"(rank {who} took the other path — non-uniform counts?)"))

    # -- drainer entry points -------------------------------------------------
    def deliver_contrib(self, rnd: int, src: int, opname: str, contrib: Any) -> None:
        with self.cond:
            cur = self.inflight.get(rnd)
            self.inbox[(rnd, src)] = (opname, contrib)
            self.cond.notify_all()
        if cur is not None and cur[1] != "star":
            # a monolithic star contribution while this rank runs another
            # tier (ring/tree or the chunked star): either a different
            # collective (opname) or — same opname — a TIER divergence
            # (e.g. non-uniform counts making the eligibility gate
            # disagree); both would hang, fail loudly
            if cur[0] != opname:
                self._mismatch(opname, cur[0])
            else:
                self._tier_mismatch(opname, src)

    def deliver_result(self, rnd: int, result: Any) -> None:
        with self.cond:
            self.inbox[(rnd,)] = result
            self.cond.notify_all()

    def deliver_chunk(self, rnd: int, src: int, opname: str, idx: int,
                      nchunks: int, part: Any) -> None:
        """A pipelined star contribution chunk (frame kind "collc")."""
        with self.cond:
            cur = self.inflight.get(rnd)
            self.inbox[(rnd, src, "c", idx)] = (opname, nchunks, part)
            self.cond.notify_all()
        if cur is not None and cur[1] != "starc":
            if cur[0] != opname:
                self._mismatch(opname, cur[0])
            else:
                self._tier_mismatch(opname, src)

    def deliver_chunk_result(self, rnd: int, idx: int, result: Any) -> None:
        with self.cond:
            self.inbox[(rnd, "cres", idx)] = result
            self.cond.notify_all()

    def deliver_alg(self, rnd: int, tag: tuple, src: int, opname: str,
                    payload: Any) -> None:
        with self.cond:
            cur = self.inflight.get(rnd)
            self.inbox[("alg", rnd) + tag] = (src, opname, payload)
            self.cond.notify_all()
        if cur is not None and cur[0] != opname:
            self._mismatch(opname, cur[0])
        elif cur is not None and cur[1] != "alg":
            self._tier_mismatch(opname, src)

    # -- algorithm tier -------------------------------------------------------
    def _send_alg(self, world_dst: int, rnd: int, tag: tuple, rank: int,
                  opname: str, payload: Any) -> None:
        self.ctx.send_frame(world_dst, ("alg", self.cid, rnd, tag, rank,
                                        opname, _pack(payload)))

    def _wait_alg(self, rnd: int, tag: tuple, opname: str) -> Any:
        key = ("alg", rnd) + tag
        with self.cond:
            self._wait_for(lambda: key in self.inbox, f"collective {opname}")
            src, got_op, payload = self.inbox.pop(key)
        if got_op != opname:
            err = CollectiveMismatchError(
                f"rank {src} is in {got_op!r} while this rank is in "
                f"{opname!r} on the same communicator")
            self.ctx.fail(err)
            raise err
        return _unpack(payload, self.ctx)

    def _run_barrier(self, rank: int, rnd: int, contrib: Any,
                     opname: str) -> None:
        """Dissemination barrier: ceil(log2 P) rounds, no distinguished root."""
        n = len(self.group)
        k, step = 1, 0
        while k < n:
            self._send_alg(self.group[(rank + k) % n], rnd, ("bar", step),
                           rank, opname, None)
            self._wait_alg(rnd, ("bar", step), opname)
            k <<= 1
            step += 1
        return None

    def _run_tree_bcast(self, rank: int, rnd: int, contrib: Any,
                        opname: str) -> Any:
        """Binomial-tree broadcast; every frame carries the claimed root so
        divergent roots are detected at the first hop."""
        n = len(self.group)
        claimed_root, payload = contrib
        v = (rank - claimed_root) % n           # virtual rank, root at 0
        if v != 0:
            got_root, payload = self._wait_alg(rnd, ("tree",), opname)
            if got_root != claimed_root:
                err = CollectiveMismatchError(
                    f"ranks disagree on the root of {opname}: "
                    f"{sorted({got_root, claimed_root})}")
                self.ctx.fail(err)
                raise err
        # children of v in the binomial tree: v | 2^k with parent(c) == v
        for k in range(max(n - 1, 1).bit_length()):
            c = v | (1 << k)
            if c != v and c < n and (c & (c - 1)) == v:
                dst = self.group[(c + claimed_root) % n]
                self._send_alg(dst, rnd, ("tree",), rank, opname,
                               (claimed_root, payload))
        return payload

    def _run_ring_allreduce(self, rank: int, rnd: int, contrib: Any, op,
                            opname: str) -> Any:
        """Ring reduce-scatter + ring allgather (the classic bandwidth-optimal
        algorithm libmpi uses for large Allreduce): each process sends
        2(P-1)/P of the payload total, versus the star's P·payload ingress at
        one process. Requires a commutative op (ring order ≠ rank order)."""
        n = len(self.group)
        arr = np.asarray(contrib)
        if (is_wire_snapshot(arr) and arr.flags.writeable
                and arr.flags.c_contiguous):
            # explicitly-marked private to_wire snapshot (the
            # provenance marker, not inferred flags, authorizes the
            # in-place fast path — an owning array shared with the user
            # can never carry the mark) — mutate instead of a second copy
            work = arr.reshape(-1)
        else:
            work = np.ascontiguousarray(arr).reshape(-1).copy()
        base, rem = divmod(len(work), n)
        sizes = [base + (1 if i < rem else 0) for i in range(n)]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        right = self.group[(rank + 1) % n]

        def seg(i: int):
            return work[offs[i]:offs[i + 1]]

        ufunc = getattr(op, "ufunc", None)
        for step in range(n - 1):           # reduce-scatter
            si = (rank - step) % n
            self._send_alg(right, rnd, ("ring", step), rank, opname, seg(si))
            incoming = self._wait_alg(rnd, ("ring", step), opname)
            ri = (rank - step - 1) % n
            if ufunc is not None:           # in-place: no temp allocation
                ufunc(seg(ri), incoming, out=seg(ri))
            else:
                seg(ri)[...] = op(seg(ri), incoming)
        for step in range(n - 1):           # allgather
            gi = (rank + 1 - step) % n
            self._send_alg(right, rnd, ("rga", step), rank, opname, seg(gi))
            incoming = self._wait_alg(rnd, ("rga", step), opname)
            wi = (rank - step) % n
            seg(wi)[...] = incoming
        return work.reshape(arr.shape)

    @staticmethod
    def _alg_array(contrib: Any, n: int,
                   threshold: bool = True) -> Optional[Any]:
        """The payload IF it is eligible for an algorithm tier (big enough,
        numeric, splittable n ways); None → use the star. One rule shared
        by every chooser branch so the tiers cannot drift.
        ``threshold=False`` skips the byte floor: an explicitly-selected
        algorithm (tuned table / force-override) already made the size
        decision, only the structural gates remain. A tensor is judged by
        its dtype and size alone, wherever it lives — a CUDA payload takes
        the tier a numpy payload of the same bytes takes (the runner moves
        it to the host once, :meth:`_on_host`), bfloat16 included (the
        host tiers fold its bits through :class:`_Bf16Op`)."""
        if isinstance(contrib, torch.Tensor):
            size = contrib.numel()
            nbytes = size * contrib.element_size()
            arr = contrib
        else:
            try:
                arr = np.asarray(contrib)
            except Exception:
                return None
            if arr.dtype == object:
                return None
            size, nbytes = arr.size, arr.nbytes
        if size % n:
            return None
        if threshold and nbytes < _RING_MIN_BYTES:
            return None
        return arr

    @staticmethod
    def _on_host(runner: Callable) -> Callable:
        """Wrap an array runner for tensor payloads: the payload crosses to
        the host in one counted copy, the runner moves and folds numpy as
        the JAX package's does, and the result returns to the tensor's
        device and dtype in one counted copy."""
        def run(rank: int, rnd: int, contrib: Any, opname: str) -> Any:
            host, like = _hostify(contrib)
            return _from_host(runner(rank, rnd, host, opname), like)
        return run

    def _run_ring_allgather(self, rank: int, rnd: int, contrib: Any,
                            opname: str) -> Any:
        """Ring allgather (each block travels n-1 single hops): every rank
        forwards the newest block to its right neighbor, so total wire
        traffic is (n-1)·block per rank versus the star root's P·block
        ingress plus P²·block egress. Result = rank-ordered concatenation,
        matching the star combine."""
        n = len(self.group)
        arr = np.asarray(contrib).reshape(-1)
        per = arr.size
        out = np.empty(n * per, arr.dtype)
        blocks = out.reshape(n, per)
        blocks[rank] = arr
        right = self.group[(rank + 1) % n]
        cur = rank
        for step in range(n - 1):
            self._send_alg(right, rnd, ("rag", step), rank, opname,
                           blocks[cur])
            cur = (rank - step - 1) % n
            incoming = np.asarray(self._wait_alg(rnd, ("rag", step), opname))
            if incoming.size != per or incoming.dtype != arr.dtype:
                err = MPIError(
                    f"Allgather blocks disagree across ranks "
                    f"(got {incoming.size} x {incoming.dtype}, expected "
                    f"{per} x {arr.dtype}); Allgather requires uniform "
                    f"counts — use Allgatherv for ragged blocks")
                self.ctx.fail(err)
                raise err
            blocks[cur] = incoming.reshape(-1)
        return out

    def _run_ring_allgatherv(self, rank: int, rnd: int, contrib: Any,
                             opname: str, counts: Sequence[int]) -> Any:
        """Ragged ring allgather: blocks of differing (replicated-counts)
        sizes forward around the ring; written straight into a preallocated
        rank-ordered output, each incoming block validated against the
        counts contract like the uniform ring tier."""
        n = len(self.group)
        arr = np.asarray(contrib).reshape(-1)
        displs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        out = np.empty(int(displs[-1]), arr.dtype)

        def blk(i: int):
            return out[displs[i]:displs[i + 1]]

        blk(rank)[...] = arr
        right = self.group[(rank + 1) % n]
        cur = rank
        for step in range(n - 1):
            self._send_alg(right, rnd, ("ragv", step), rank, opname,
                           blk(cur))
            cur = (rank - step - 1) % n
            incoming = np.asarray(
                self._wait_alg(rnd, ("ragv", step), opname)).reshape(-1)
            if incoming.size != counts[cur] or incoming.dtype != arr.dtype:
                err = MPIError(
                    f"Allgatherv block from rank {cur} is "
                    f"{incoming.size} x {incoming.dtype}, but the replicated "
                    f"counts promise {counts[cur]} x {arr.dtype}")
                self.ctx.fail(err)
                raise err
            blk(cur)[...] = incoming
        return out

    def _run_pairwise_alltoallv(self, rank: int, rnd: int, contrib: Any,
                                opname: str) -> Any:
        """Variable-count pairwise exchange: like the Alltoall tier but each
        (src, dst) segment has its own length, carried by the frame itself
        (the star combine also slices by the SENDER's counts, so semantics
        agree even if a buggy caller's rcounts disagree)."""
        n = len(self.group)
        wire, scounts = contrib
        arr = np.asarray(wire).reshape(-1)
        sd = np.concatenate([[0], np.cumsum(scounts)]).astype(np.int64)
        for k in range(1, n):
            dst = (rank + k) % n
            self._send_alg(self.group[dst], rnd, ("a2av", rank), rank,
                           opname, arr[sd[dst]:sd[dst + 1]])
        parts: list = [None] * n
        parts[rank] = arr[sd[rank]:sd[rank + 1]]
        for k in range(1, n):
            src = (rank - k) % n
            parts[src] = self._wait_alg(rnd, ("a2av", src), opname)
        out = np.concatenate([np.asarray(p).reshape(-1) for p in parts])
        return out

    def _run_pairwise_alltoall(self, rank: int, rnd: int, contrib: Any,
                               opname: str) -> Any:
        """Direct pairwise exchange (MPI_Alltoall's large-message algorithm):
        each of my P-1 foreign segments travels ONE hop to its owner, versus
        the star's P·payload ingress at the root. Result for slot s = rank
        s's segment for me, matching the star combine exactly."""
        n = len(self.group)
        arr = np.asarray(contrib)
        segs = arr.reshape(n, arr.size // n)
        for k in range(1, n):
            dst = (rank + k) % n
            self._send_alg(self.group[dst], rnd, ("a2a", rank), rank, opname,
                           segs[dst])
        out = np.empty_like(segs)
        out[rank] = segs[rank]
        for k in range(1, n):
            src = (rank - k) % n
            out[src] = self._wait_alg(rnd, ("a2a", src), opname)
        return out.reshape(-1)

    def _run_rdouble_allreduce(self, rank: int, rnd: int, contrib: Any,
                               combine: Callable, opname: str) -> Any:
        """Recursive-doubling Allreduce in its concatenation form (a Bruck
        allgather of the raw contributions, then the star's OWN rank-order
        fold at every rank): ceil(log2 P) pairwise exchange rounds, each
        shipping everything accumulated so far, versus the star's
        serialized O(P) root ingress. Running the same ``combine`` closure
        the star root runs, over the same rank-ordered contribution list,
        makes the result bitwise-identical to the star by construction —
        any op (commutative or not), any picklable payload."""
        n = len(self.group)
        have = {rank: contrib}
        k, step = 1, 0
        while k < n:
            dst = self.group[(rank + k) % n]
            self._send_alg(dst, rnd, ("rd", step), rank, opname,
                           list(have.items()))
            for src, c in self._wait_alg(rnd, ("rd", step), opname):
                have.setdefault(src, c)
            k <<= 1
            step += 1
        results = list(combine([have[r] for r in range(n)]))
        if len(results) != n:
            err = MPIError(f"combine for {opname} returned {len(results)} "
                           f"results for {n} ranks")
            self.ctx.fail(err)
            raise err
        return results[rank]

    def _run_rabenseifner_allreduce(self, rank: int, rnd: int, contrib: Any,
                                    op, opname: str) -> Any:
        """Rabenseifner's algorithm: a direct-exchange reduce-scatter (each
        rank becomes the owner of one payload segment and folds the P
        per-rank pieces of it) followed by an allgather of the folded
        segments — 2·bytes·(P-1)/P wire traffic per rank like the ring,
        but in 2·log-ish phases of P-1 concurrent single-hop messages
        instead of 2(P-1) serialized ring steps. Each segment folds in
        RANK ORDER with the same ``functools.reduce`` the star's
        ``_reduce_arrays`` bottoms out in; the elementwise ops this tier
        admits are segment-separable, so the concatenated result is
        bitwise-identical to the star's monolithic fold."""
        import functools as _ft
        n = len(self.group)
        host = np.asarray(contrib)
        work = np.ascontiguousarray(host).reshape(-1)
        base, rem = divmod(work.size, n)
        sizes = [base + (1 if i < rem else 0) for i in range(n)]
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

        # phase 1 (reduce-scatter): ship my copy of segment d to its owner
        for k in range(1, n):
            dst = (rank + k) % n
            self._send_alg(self.group[dst], rnd, ("rsp", rank), rank,
                           opname, work[offs[dst]:offs[dst + 1]])
        pieces: list = [None] * n
        pieces[rank] = work[offs[rank]:offs[rank + 1]]
        for k in range(1, n):
            src = (rank - k) % n
            pieces[src] = np.asarray(
                self._wait_alg(rnd, ("rsp", src), opname)).reshape(-1)
        folded = np.asarray(_ft.reduce(op, pieces)).reshape(-1)

        # phase 2: Bruck allgather of the folded segments
        merged = {rank: folded}
        k, step = 1, 0
        while k < n:
            dst = self.group[(rank + k) % n]
            self._send_alg(dst, rnd, ("rag2", step), rank, opname,
                           list(merged.items()))
            for src, seg in self._wait_alg(rnd, ("rag2", step), opname):
                merged.setdefault(src, np.asarray(seg).reshape(-1))
            k <<= 1
            step += 1
        out = np.concatenate([merged[r] for r in range(n)])
        return out.reshape(host.shape)

    # -- hierarchical (two-level) composites --------------------------------
    #
    # The domain map (tpu_mpi_torch/topology.py) splits this communicator into D
    # contiguous equal blocks of r ranks (one block per host, or the
    # TPU_MPI_DOMAINS emulation); member i is (domain i // r, position
    # i % r). Intra-domain traffic is cheap (shm/loopback), inter-domain
    # traffic crosses the slow fabric — each composite sends O(D) inter
    # messages per member where the flat algorithms send O(n).

    def _hier_layout(self) -> Optional[tuple]:
        """(ndomains, ranks_per_domain) for this group, or None when the
        world is flat or the layout is not contiguous-uniform (the only
        shape whose cross-domain fold chain stays bitwise-equal to the
        star — see topology.domain_shape)."""
        from . import topology as _topo
        return _topo.domain_shape(_topo.domain_map(self.ctx, self.group))

    def _run_hier_allreduce(self, rank: int, rnd: int, contrib: Any,
                            op, opname: str, layout: tuple) -> Any:
        """Two-level Allreduce: intra-domain gather of raw segment pieces,
        a cross-domain CHAIN of partial left folds, then backfill +
        intra-domain allgather. The payload splits into r segments (one
        per domain position, rabenseifner-style); segment p's owner in
        domain d is position p. The chain runs in domain order — domain 0
        folds its r pieces of segment p in rank order, ships the partial
        to domain 1 whose owner folds ``[carried] + its r pieces``, and so
        on — so the final domain holds EXACTLY the star's left fold of all
        n pieces in rank order (left folds compose under chunking), and
        the elementwise ops this tier admits are segment-separable. Inter
        traffic: 2·(D-1) segment-sized hops per position, vs the star's
        n-1 full-payload root ingress crossing the fabric."""
        import functools as _ft
        D, r = layout
        n = len(self.group)
        host = np.asarray(contrib)
        work = np.ascontiguousarray(host).reshape(-1)
        base, rem = divmod(work.size, r)
        sizes = [base + (1 if p < rem else 0) for p in range(r)]
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        dom, pos = rank // r, rank % r
        sc = _pv.scope()    # pvar phase spans; None when pvars+tracing off

        # phase 1 (intra gather): my piece of segment q goes to my
        # domain's position-q member; I collect my co-members' pieces of
        # MY segment, in position (= rank) order
        t0 = sc.start() if sc is not None else 0.0
        for q in range(r):
            if q == pos:
                continue
            self._send_alg(self.group[dom * r + q], rnd, ("hrs", rank),
                           rank, opname, work[offs[q]:offs[q + 1]])
        pieces: list = [None] * r
        pieces[pos] = work[offs[pos]:offs[pos + 1]]
        for q in range(r):
            if q != pos:
                pieces[q] = np.asarray(self._wait_alg(
                    rnd, ("hrs", dom * r + q), opname)).reshape(-1)
        if sc is not None:
            t0 = sc.phase("intra_fold", t0)

        # phase 2 (inter chain): fold and carry the partial down the
        # domain chain; the last domain ends with the full rank-order fold
        if dom == 0:
            partial = np.asarray(_ft.reduce(op, pieces)).reshape(-1)
        else:
            carried = np.asarray(self._wait_alg(
                rnd, ("hch", (dom - 1) * r + pos), opname)).reshape(-1)
            partial = np.asarray(
                _ft.reduce(op, [carried] + pieces)).reshape(-1)
        if dom < D - 1:
            self._send_alg(self.group[(dom + 1) * r + pos], rnd,
                           ("hch", rank), rank, opname, partial)
            final = np.asarray(self._wait_alg(
                rnd, ("hbf", (D - 1) * r + pos), opname)).reshape(-1)
        else:
            final = partial
            for d in range(D - 1):
                self._send_alg(self.group[d * r + pos], rnd, ("hbf", rank),
                               rank, opname, final)
        if sc is not None:
            t0 = sc.phase("inter_exchange", t0)

        # phase 3 (intra allgather): everyone shares their finished
        # segment with their co-members and reassembles in segment order
        for q in range(r):
            if q != pos:
                self._send_alg(self.group[dom * r + q], rnd, ("hag", rank),
                               rank, opname, final)
        segs: list = [None] * r
        segs[pos] = final
        for q in range(r):
            if q != pos:
                segs[q] = np.asarray(self._wait_alg(
                    rnd, ("hag", dom * r + q), opname)).reshape(-1)
        out = np.concatenate(segs)
        if sc is not None:
            sc.phase("allgather", t0)
        return out.reshape(host.shape)

    def _run_hier_allgather(self, rank: int, rnd: int, contrib: Any,
                            opname: str, layout: tuple) -> Any:
        """Two-level Allgather: intra-domain pairwise allgather of the
        blocks, then one bundle (the domain's r blocks) per member to its
        position peer in every other domain — D-1 inter messages per
        member instead of the (D-1)·r a flat pairwise exchange crosses
        the fabric with. Pure rank-ordered concatenation, so bitwise
        equality to the star is structural."""
        D, r = layout
        n = len(self.group)
        blk = np.asarray(contrib).reshape(-1)
        dom, pos = rank // r, rank % r
        sc = _pv.scope()
        t0 = sc.start() if sc is not None else 0.0
        for q in range(r):
            if q != pos:
                self._send_alg(self.group[dom * r + q], rnd, ("hga", rank),
                               rank, opname, blk)
        bundle: list = [None] * r
        bundle[pos] = blk
        for q in range(r):
            if q != pos:
                got = np.asarray(self._wait_alg(
                    rnd, ("hga", dom * r + q), opname)).reshape(-1)
                if got.size != blk.size or got.dtype != blk.dtype:
                    err = MPIError(
                        f"Allgather block mismatch in {opname}: rank "
                        f"{dom * r + q} sent {got.size}x{got.dtype}, "
                        f"rank {rank} holds {blk.size}x{blk.dtype}")
                    self.ctx.fail(err)
                    raise err
                bundle[q] = got
        if sc is not None:
            t0 = sc.phase("intra_fold", t0)
        for d in range(D):
            if d != dom:
                self._send_alg(self.group[d * r + pos], rnd, ("hgb", rank),
                               rank, opname, np.concatenate(bundle))
        blocks: list = [None] * n
        for q in range(r):
            blocks[dom * r + q] = bundle[q]
        for d in range(D):
            if d == dom:
                continue
            got = np.asarray(self._wait_alg(
                rnd, ("hgb", d * r + pos), opname)).reshape(-1)
            if got.size != r * blk.size:
                err = MPIError(
                    f"Allgather bundle mismatch in {opname}: domain {d} "
                    f"sent {got.size} elements, expected {r * blk.size}")
                self.ctx.fail(err)
                raise err
            for q in range(r):
                blocks[d * r + q] = got[q * blk.size:(q + 1) * blk.size]
        if sc is not None:
            t0 = sc.phase("inter_exchange", t0)
        out = np.concatenate(blocks)
        if sc is not None:
            sc.phase("allgather", t0)
        return out

    def _run_hier_alltoall(self, rank: int, rnd: int, contrib: Any,
                           opname: str, layout: tuple) -> Any:
        """Two-level Alltoall: segments for co-members travel directly;
        segments for a foreign domain ride ONE bundle to my position peer
        there, who forwards each piece intra-domain to its final owner —
        D-1 inter messages per member (bundle size r·seg) instead of the
        flat pairwise exchange's (D-1)·r fabric crossings. A pure
        permutation: every slot receives exactly the sender's segment,
        bitwise."""
        D, r = layout
        n = len(self.group)
        arr = np.asarray(contrib)
        segs = arr.reshape(n, arr.size // n)
        dom, pos = rank // r, rank % r
        sc = _pv.scope()
        t0 = sc.start() if sc is not None else 0.0
        # intra: direct segment to each co-member
        for q in range(r):
            if q != pos:
                self._send_alg(self.group[dom * r + q], rnd, ("hai", rank),
                               rank, opname, segs[dom * r + q])
        if sc is not None:
            t0 = sc.phase("intra_fold", t0)
        # inter: one bundle (their domain's r segments, position order)
        # to my position peer in every other domain
        for d in range(D):
            if d != dom:
                self._send_alg(
                    self.group[d * r + pos], rnd, ("hab", rank), rank,
                    opname,
                    np.concatenate([segs[d * r + q] for q in range(r)]))
        out = np.empty_like(segs)
        out[rank] = segs[rank]
        seg_sz = segs.shape[1]
        # receive + forward: peer bundles carry my whole domain's pieces
        # from the sender's domain; mine I keep, the rest I relay
        for d in range(D):
            if d == dom:
                continue
            src = d * r + pos
            got = np.asarray(self._wait_alg(
                rnd, ("hab", src), opname)).reshape(r, seg_sz)
            out[src] = got[pos]
            for q in range(r):
                if q != pos:
                    self._send_alg(self.group[dom * r + q], rnd,
                                   ("haf", src), rank, opname, got[q])
        if sc is not None:
            t0 = sc.phase("inter_exchange", t0)
        # collect: co-members' direct segments, then forwarded foreign
        # segments (from the co-member at the original sender's position)
        for q in range(r):
            if q != pos:
                out[dom * r + q] = self._wait_alg(
                    rnd, ("hai", dom * r + q), opname)
        for d in range(D):
            if d == dom:
                continue
            for q in range(r):
                if q != pos:
                    out[d * r + q] = self._wait_alg(
                        rnd, ("haf", d * r + q), opname)
        if sc is not None:
            sc.phase("allgather", t0)
        return out.reshape(-1)

    def _run_tree_gather_fold(self, rank: int, rnd: int, contrib: Any,
                              combine: Callable, opname: str) -> Any:
        """Binomial-tree gather for rooted Reduce/Gather: contributions
        merge up a binomial tree to COMM rank 0 (the star's fold site) in
        log P rounds instead of P-1 serialized root receives; comm rank 0
        runs the star's OWN rooted combine — root-divergence validation
        and rank-order fold included, so results are bitwise-identical —
        and ships the (single) non-None result to the claimed root. The
        contribs are the ``_run_rooted`` (claimed_root, payload) pairs:
        each rank knows from its own pair whether a result is due."""
        n = len(self.group)
        bundle = {rank: contrib}
        for k in range(max(n - 1, 1).bit_length()):
            c = rank | (1 << k)
            if c != rank and c < n and (c & (c - 1)) == rank:
                bundle.update(self._wait_alg(rnd, ("btg", c), opname))
        if rank != 0:
            parent = rank & (rank - 1)
            self._send_alg(self.group[parent], rnd, ("btg", rank), rank,
                           opname, bundle)
            if contrib[0] == rank:       # I am the claimed root: result due
                return self._wait_alg(rnd, ("btr",), opname)
            return None
        results = list(combine([bundle[r] for r in range(n)]))
        if len(results) != n:
            err = MPIError(f"combine for {opname} returned {len(results)} "
                           f"results for {n} ranks")
            self.ctx.fail(err)
            raise err
        for r in range(1, n):
            if results[r] is not None:
                self._send_alg(self.group[r], rnd, ("btr",), rank, opname,
                               results[r])
        return results[0]

    def _run_tree_scatter(self, rank: int, rnd: int, contrib: Any,
                          combine: Callable, opname: str) -> Any:
        """Binomial-tree scatter rooted at the claimed root (virtual rank
        0): the root runs the star's combine to slice its payload into
        per-rank blocks, then each tree hop forwards the contiguous
        virtual-rank block range its child subtree owns — log P hops of
        geometrically-shrinking bundles instead of P-1 serialized root
        sends. Every frame carries the claimed root (like the binomial
        Bcast), so divergent roots fail loudly at the first hop rather
        than through the star's gathered-pair check."""
        n = len(self.group)
        claimed_root = contrib[0]
        v = (rank - claimed_root) % n          # virtual rank, root at 0

        def vchildren(vr: int):
            for k in range(max(n - 1, 1).bit_length()):
                c = vr | (1 << k)
                if c != vr and c < n and (c & (c - 1)) == vr:
                    yield c, min(c + (1 << k), n)

        if v == 0:
            # Synthesize the star's gathered view. Only the root's payload
            # feeds the scatter combine; peer claimed-roots are validated
            # at the receive hops below instead of here.
            cs: list = [(claimed_root, None)] * n
            cs[rank] = contrib
            results = list(combine(cs))
            if len(results) != n:
                err = MPIError(f"combine for {opname} returned "
                               f"{len(results)} results for {n} ranks")
                self.ctx.fail(err)
                raise err
            blocks = {u: results[(u + claimed_root) % n] for u in range(n)}
        else:
            got_root, blocks = self._wait_alg(rnd, ("sctr", v), opname)
            if got_root != claimed_root:
                err = CollectiveMismatchError(
                    f"ranks disagree on the root of {opname}: "
                    f"{sorted({got_root, claimed_root})}")
                self.ctx.fail(err)
                raise err
        for c, end in vchildren(v):
            self._send_alg(self.group[(c + claimed_root) % n], rnd,
                           ("sctr", c), rank, opname,
                           (claimed_root,
                            {u: blocks[u] for u in range(c, end)}))
        return blocks[v]

    def shm_bind(self, nbytes: int) -> Optional[Callable[[], None]]:
        """Pre-map the same-host shm collective segment for a registered
        plan (tpu_mpi_torch.collective._register_allreduce) and take a slot
        lease, so the first Start pays neither the eligibility walk nor
        the lazy mmap. Returns the release callback the registration hands
        to ``Comm.free``, or None when the tier is not eligible (not
        same-host, payload exceeds the mapped slot size) — the plan then
        simply runs without a segment lease."""
        ok = getattr(self.ctx, "coll_shm_ok", None)
        if ok is None or not self.group or not ok(self.group):
            return None
        try:
            sc = self._shm_coll()
        except MPIError:
            return None             # plan creation must not fate-share
        if nbytes > sc.cap:
            return None
        sc.leases += 1

        def release() -> None:
            sc.leases = max(0, sc.leases - 1)
        return release

    def drop_shm(self) -> None:
        """Tear down the mapped segment once every registered-plan lease is
        gone (``Comm.free``): unlink the name and close the mapping. A
        BufferError (a live numpy view still pins the map) keeps the
        mapping — the view owner drops it with the comm object."""
        sc = self._shm
        if sc is None or sc.leases > 0:
            return
        self._shm = None
        sc.maybe_unlink()
        try:
            sc.mm.close()
        except BufferError:
            self._shm = sc          # a slot view is still alive; keep it

    def _shm_coll(self) -> _ShmColl:
        if self._shm is None:
            try:
                self._shm = _ShmColl(self.ctx, self.cid, self.group)
            except MPIError:
                raise
            except OSError as e:
                # eligibility said same-host + /dev/shm exists, so a map
                # failure here is environmental (full tmpfs, perms) and
                # must fate-share — a silent per-rank star fallback would
                # diverge the protocol
                err = MPIError(
                    f"could not map the shm collective segment: {e}")
                self.ctx.fail(err)
                raise err from None
        return self._shm

    def _run_shm(self, rank: int, rnd: int, contrib: Any,
                 combine: Callable, opname: str) -> Any:
        """Same-host shared-memory collective (Allreduce with a raw array
        payload; Barrier with ``contrib=None``): ranks publish through one
        mmap'd segment and comm rank 0 folds with the star's OWN combine
        closure over the rank-ordered slot views — bitwise-identical by
        construction — then publishes the (rank-uniform) result slot. No
        transport frames at all, which on a single host beats every
        message-passing algorithm by an order of magnitude at small sizes
        (the measured crossovers in benchmarks/results/coll-algos-*.json
        are what put this tier in the tuned table)."""
        ctx = self.ctx
        sc = self._shm_coll()
        n = len(self.group)
        want = rnd + 1
        ophash = zlib.crc32(opname.encode())
        if contrib is None:                       # Barrier
            flat = host = None
            dthash = 0
        else:
            host = np.asarray(contrib)
            flat = np.ascontiguousarray(host).reshape(-1)
            dthash = zlib.crc32(flat.dtype.str.encode())
            if flat.nbytes > sc.cap:
                err = MPIError(
                    f"shm collective payload ({flat.nbytes} B) exceeds the "
                    f"mapped slot size ({sc.cap} B) — "
                    f"TPU_MPI_COLL_SHM_MAX_BYTES changed mid-job?")
                ctx.fail(err)
                raise err
        if rank != 0:
            sc.publish(rank, want, ophash, dthash,
                       None if flat is None else memoryview(flat).cast("B"))
            sc.spin(sc.n, want, opname)
            _, nb, r_oph, _ = sc.header(sc.n)
            if r_oph != ophash:
                err = CollectiveMismatchError(
                    f"ranks disagree on the collective for cid {self.cid} "
                    f"(shm result slot carries another op than {opname!r})")
                ctx.fail(err)
                raise err
            if flat is None:
                return None
            # .copy(): the mapping is reused next round; the result dtype
            # is the contribution dtype (elementwise same-dtype fold)
            out = np.frombuffer(sc.mm, dtype=flat.dtype,
                                count=nb // flat.dtype.itemsize,
                                offset=sc.data_off(sc.n)).copy()
            return out.reshape(host.shape)

        # comm rank 0: spin per slot, validate, fold in rank order, publish
        cs: list = [None] * n
        cs[0] = contrib
        for r in range(1, n):
            sc.spin(r, want, opname)
            _, nb, c_oph, c_dth = sc.header(r)
            if c_oph != ophash or c_dth != dthash:
                err = CollectiveMismatchError(
                    f"ranks disagree on the collective for cid {self.cid}: "
                    f"rank {r}'s shm contribution carries another "
                    f"op/dtype than {opname!r}")
                ctx.fail(err)
                raise err
            if flat is not None:
                if nb != flat.nbytes:
                    err = MPIError(
                        f"shm {opname} contributions disagree on size "
                        f"(rank {r}: {nb} B, expected {flat.nbytes} B) — "
                        f"non-uniform counts?")
                    ctx.fail(err)
                    raise err
                cs[r] = np.frombuffer(sc.mm, dtype=flat.dtype,
                                      count=flat.size,
                                      offset=sc.data_off(r)
                                      ).reshape(host.shape)
        # every rank has provably mapped this inode now — drop the name
        sc.maybe_unlink()
        if flat is None:
            sc.publish(sc.n, want, ophash, 0, None)
            return None
        try:
            results = list(combine(cs))
        except BaseException as e:
            ctx.fail(e)
            raise
        res = np.ascontiguousarray(np.asarray(results[0])).reshape(-1)
        if res.dtype != flat.dtype or res.nbytes > sc.cap:
            err = MPIError(
                f"shm {opname} fold changed dtype/size "
                f"({flat.dtype}->{res.dtype}); this op is not eligible "
                f"for the shm tier")
            ctx.fail(err)
            raise err
        sc.publish(sc.n, want, ophash, dthash, memoryview(res).cast("B"))
        return results[rank]

    def _choose_algorithm(self, contrib: Any, plan,
                          combine: Callable) -> Optional[tuple]:
        """Resolve a plan's algorithm to a ``(mode, runner)`` pair, or None
        for the star (monolithic or chunk-pipelined). Plans from the
        current ``tpu_mpi_torch.collective`` carry the ``tune.select`` decision
        as their last element; legacy hints without it keep the historical
        gates. The decision must stay a deterministic function of values
        every rank shares (plan kind, op, payload size, uniform config) or
        the protocols would diverge — and an explicitly-selected algorithm
        still passes the STRUCTURAL gates (numeric payload, divisibility),
        so a tuned table degrades to the star instead of crashing on an
        object payload. ``mode`` is the inflight tier tag cross-checked by
        the deliver_* mismatch detection ("alg" message algorithms, "shm"
        the shared-memory fold)."""
        kind = plan[0]
        n = len(self.group)
        if kind == "barrier":
            algo = plan[1] if len(plan) > 1 else "dissemination"
            if algo == "shm":
                return ("shm", lambda rank, rnd, c, opname:
                        self._run_shm(rank, rnd, None, combine, opname))
            if algo == "dissemination":
                return ("alg", self._run_barrier)
            return None
        if kind == "bcast":
            algo = plan[2] if len(plan) > 2 else "binomial"
            if algo == "binomial":
                return ("alg", self._run_tree_bcast)
            return None
        if kind == "allreduce":
            op = plan[1]
            algo = plan[2] if len(plan) > 2 else None
            if algo is None:                 # legacy hint: historical gate
                if (getattr(op, "commutative", False)
                        and self._alg_array(contrib, 1) is not None):
                    algo = "ring"
                else:
                    return None
            if algo == "rdouble":
                # the star's own combine at every rank, over the packed
                # contributions: tensors stay tensors (as the JAX package's
                # arrays stay device arrays)
                return ("alg", lambda rank, rnd, c, opname:
                        self._run_rdouble_allreduce(rank, rnd, c, combine,
                                                    opname))
            if algo not in ("shm", "rabenseifner", "ring", "hier") or \
                    self._alg_array(contrib, 1, threshold=False) is None:
                return None
            if _is_bf16(contrib):    # the host folds see its bits
                op, combine = _Bf16Op(op), _bf16_combine(combine)
            if algo == "shm":
                return ("shm", self._on_host(lambda rank, rnd, c, opname:
                        self._run_shm(rank, rnd, c, combine, opname)))
            if algo == "rabenseifner":
                return ("alg", self._on_host(lambda rank, rnd, c, opname:
                        self._run_rabenseifner_allreduce(rank, rnd, c, op,
                                                         opname)))
            if algo == "ring":
                return ("alg", self._on_host(lambda rank, rnd, c, opname:
                        self._run_ring_allreduce(rank, rnd, c, op, opname)))
            lay = self._hier_layout()
            if lay is None:         # flat world: degrade to the star
                return None
            return ("alg", self._on_host(lambda rank, rnd, c, opname:
                    self._run_hier_allreduce(rank, rnd, c, op, opname,
                                             lay)))
        if kind in ("reduce", "gather"):
            if plan[-1] == "binomial":
                return ("alg", lambda rank, rnd, c, opname:
                        self._run_tree_gather_fold(rank, rnd, c, combine,
                                                   opname))
            return None
        if kind == "scatter":
            if plan[-1] == "binomial":
                return ("alg", lambda rank, rnd, c, opname:
                        self._run_tree_scatter(rank, rnd, c, combine,
                                               opname))
            return None
        if kind == "alltoall":
            algo = plan[1] if len(plan) > 1 else "pairwise"
            legacy = len(plan) == 1
            if (algo == "pairwise" and self._alg_array(
                    contrib, n, threshold=legacy) is not None):
                return ("alg", self._on_host(self._run_pairwise_alltoall))
            if (algo == "hier" and self._alg_array(
                    contrib, n, threshold=False) is not None):
                lay = self._hier_layout()
                if lay is not None:
                    return ("alg", self._on_host(lambda rank, rnd, c, opname:
                            self._run_hier_alltoall(rank, rnd, c, opname,
                                                    lay)))
            return None
        if kind == "allgather":
            algo = plan[1] if len(plan) > 1 else "ring"
            legacy = len(plan) == 1
            if (algo == "ring" and self._alg_array(
                    contrib, 1, threshold=legacy) is not None):
                return ("alg", self._on_host(self._run_ring_allgather))
            if (algo == "hier" and self._alg_array(
                    contrib, 1, threshold=False) is not None):
                lay = self._hier_layout()
                if lay is not None:
                    return ("alg", self._on_host(lambda rank, rnd, c, opname:
                            self._run_hier_allgather(rank, rnd, c, opname,
                                                     lay)))
            return None
        if kind == "allgatherv":
            algo = plan[3] if len(plan) > 3 else "ring"
            dt = getattr(contrib, "dtype", None)
            if (algo != "ring" or dt is None or dt == object
                    or (len(plan) <= 3          # legacy: replicated total
                        and plan[1] < _RING_MIN_BYTES)):
                return None
            counts = plan[2]
            return ("alg", self._on_host(lambda rank, rnd, c, opname:
                    self._run_ring_allgatherv(rank, rnd, c, opname, counts)))
        if kind == "alltoallv":
            # counts differ per rank, so a SIZE-based gate would let ranks
            # disagree on the tier (protocol divergence); gate on the dtype
            # only, which the MPI datatype contract makes uniform. Read it
            # via the attribute — np.asarray here would pull a CUDA payload
            # to host just to inspect its dtype.
            algo = plan[1] if len(plan) > 1 else "pairwise"
            dt = getattr(contrib[0], "dtype", None) \
                if isinstance(contrib, tuple) and contrib else None
            if algo != "pairwise" or dt is None or dt == object:
                return None
            return ("alg", self._on_host(self._run_pairwise_alltoallv))
        return None

    def _choose_chunked(self, contrib: Any, plan):
        """The chunk-pipelined star's eligibility (overlap engine): a bulk
        Allreduce the ring DECLINED (non-commutative op, or ring disabled)
        over a known-elementwise op, above ``pipeline_min_bytes``. Returns
        (op, schedule) or None. Like every tier gate, the decision is a
        deterministic function of rank-uniform values (plan kind, op,
        payload size/dtype, config) — and the chunk frames carry the chunk
        count so a divergent pipeline config still fails loudly instead of
        hanging."""
        if not plan or plan[0] != "allreduce":
            return None
        from .operators import is_elementwise
        op = plan[1]
        if not is_elementwise(op):
            return None
        if isinstance(contrib, torch.Tensor):
            size, item = contrib.numel(), contrib.element_size()
        else:
            try:
                arr = np.asarray(contrib)
            except Exception:
                return None
            if arr.dtype == object:
                return None
            size, item = arr.size, arr.dtype.itemsize
        from .overlap import ChunkSchedule
        sched = ChunkSchedule.maybe(size, item)
        if sched is None:
            return None
        return (_Bf16Op(op) if _is_bf16(contrib) else op, sched)

    # -- the collective contract ---------------------------------------------
    def run(self, rank: int, contrib: Any,
            combine: Callable[[list[Any]], Sequence[Any]], opname: str,
            plan=None, stamp: Any = None) -> Any:
        # ``stamp`` (the thread tier's cross-rank round key) is not sent:
        # here each rank's rounds travel as its own numbered frames
        ctx = self.ctx
        n = len(self.group)
        chosen = (self._choose_algorithm(contrib, plan, combine)
                  if (plan and n > 1) else None)
        chunked = None
        if chosen is None and plan and n > 1:
            chunked = self._choose_chunked(contrib, plan)
        mode = chosen[0] if chosen is not None \
            else ("starc" if chunked else "star")
        with self.cond:
            rnd = self.round
            self.round += 1
            self.inflight[rnd] = (opname, mode)
            # Frames of this round may have arrived before we entered: sweep
            # them for cross-tier mismatches the delivery check couldn't see.
            stale = tier_diverged = None
            for key, val in self.inbox.items():
                if key[0] == "alg" and key[1] == rnd:
                    if mode == "alg":
                        continue
                    if val[1] != opname:
                        stale = val[1]
                    else:
                        tier_diverged = val[0]   # same op, other tier
                elif not (isinstance(key[0], int) and key[0] == rnd):
                    continue
                elif len(key) == 2:              # monolithic star contrib
                    if mode == "star":
                        continue
                    if val[0] != opname:
                        stale = val[0]
                    else:
                        tier_diverged = key[1]
                elif len(key) == 4 and key[2] == "c":   # chunked contrib
                    if mode == "starc":
                        continue
                    if val[0] != opname:
                        stale = val[0]
                    else:
                        tier_diverged = key[1]
        if stale is not None:
            self._mismatch(stale, opname)
            ctx.check_failure()
        if tier_diverged is not None:
            self._tier_mismatch(opname, tier_diverged)
            ctx.check_failure()
        try:
            if chosen is not None:
                return chosen[1](rank, rnd, contrib, opname)
            if chunked is not None:
                return self._on_host(
                    lambda rank, rnd, c, opname: self._run_star_chunked(
                        rank, rnd, c, chunked[0], chunked[1], opname))(
                    rank, rnd, contrib, opname)
            return self._run_star(rank, rnd, contrib, combine, opname)
        except BaseException as e:
            # ULFM errors stay LOCAL: the failure detector already woke
            # every survivor, and each raises its own typed error —
            # broadcasting an abort here would replace recoverable
            # ProcFailedError/RevokedError with fatal AbortError job-wide
            # and poison this rank's own recovery path (Comm_shrink).
            from .error import ProcFailedError as _PF, RevokedError as _RV
            if ctx.failure is None and not isinstance(e, (_PF, _RV)):
                ctx.fail(e)
            raise
        finally:
            with self.cond:
                self.inflight.pop(rnd, None)

    def _result_wait(self, rnd: int, key: Any, opname: str) -> Any:
        """Wait for ``inbox[key]`` (a star/chunked result from the root) with
        the busy-probe escape hatch, and pop it. The root may be legitimately
        slow INSIDE combine (a first-use kernel build on big shapes): before declaring deadlock, ask its drainer whether the
        round is still in flight; a dead root surfaces via abort frames in
        check_failure instead. The ping ships with the cond RELEASED: a blocking transport send under the lock the drainer
        needs to deliver frames here could wedge both this thread and the
        drainer on a backed-up socket."""
        ctx = self.ctx
        root_world = self.group[0]
        while True:
            with self.cond:
                try:
                    self._wait_for(lambda: key in self.inbox,
                                   f"collective {opname}",
                                   limit=collective_wait_limit(opname))
                    return self.inbox.pop(key)
                except DeadlockError as e:
                    deadlock = e
                    self.probing.add(rnd)
            got = busy = False
            try:
                self._send(root_world, ("collping", self.cid, rnd,
                                        ctx.local_rank), opname)
                with self.cond:
                    got = self._wait_for(
                        lambda: (key in self.inbox
                                 or ("pong", rnd) in self.inbox),
                        f"collective {opname} (busy probe)",
                        timeout=15.0)
                    busy = self.inbox.pop(("pong", rnd), False)
            finally:
                # discard AND sweep under one cond hold: a pong landing
                # between the probe wait's exit and the discard would
                # otherwise sit in the inbox forever (the collpong
                # handler gates on probing membership under this cond)
                with self.cond:
                    self.probing.discard(rnd)
                    self.inbox.pop(("pong", rnd), None)
            with self.cond:
                if key in self.inbox:
                    return self.inbox.pop(key)
            if not (got and busy):
                raise deadlock

    def _run_star_chunked(self, rank: int, rnd: int, contrib: Any, op,
                          schedule, opname: str) -> Any:
        """Chunk-pipelined star Allreduce (overlap engine): contributions
        travel as K chunk frames; the root folds chunk k in rank order AS
        SOON as every rank's chunk k has landed — while its drainer keeps
        receiving chunks k+1..K-1 concurrently (the fold runs with the cond
        released) — and ships each result chunk immediately. Transfer and
        fold genuinely overlap, and peers start receiving results before the
        last contribution chunk was even sent. Bitwise-equal to the
        monolithic star: same rank-order fold over the same elements, just
        chunk-separated (the eligibility gate admits elementwise ops only)."""
        import functools as _ft
        from .overlap import progress_begin, progress_note

        ctx = self.ctx
        n = len(self.group)
        K = schedule.nchunks
        root_world = self.group[0]
        arr = np.asarray(contrib).reshape(-1)
        prog = progress_begin(K, "chunks")
        sc = _pv.scope()    # pvar phase spans; None when pvars+tracing off
        if ctx.local_rank != root_world:
            t0 = sc.start() if sc is not None else 0.0
            # one coalesced flush for the whole chunk run: K contribution
            # frames ride one framed message / one writev
            self._send_batch(
                root_world,
                [("collc", self.cid, rnd, rank, opname, idx, K,
                  _pack(arr[lo:hi])) for idx, (lo, hi) in enumerate(schedule)],
                opname)
            if sc is not None:
                t0 = sc.phase("copy", t0)
            parts = []
            for idx in range(K):
                parts.append(np.asarray(_unpack(
                    self._result_wait(rnd, (rnd, "cres", idx), opname), ctx))
                    .reshape(-1))
                progress_note(prog)
            if sc is not None:
                sc.phase("rendezvous", t0)
            return np.concatenate(parts)

        # root: per-chunk gather -> rank-order fold -> immediate scatter.
        # The per-phase sums double as the overlap-fraction inputs: chunk-k
        # rendezvous waits AFTER the first chunk are exactly the transfer
        # time the pipeline failed to hide behind the chunk-(k-1) fold.
        others = [r for r in range(n) if r != rank]
        res_parts = []
        fold_ns = wait_after_first_ns = 0
        for idx, (lo, hi) in enumerate(schedule):
            tw = sc.start() if sc is not None else 0.0
            with self.cond:
                self._wait_for(
                    lambda: all((rnd, r, "c", idx) in self.inbox
                                for r in others),
                    f"collective {opname} (chunk {idx})",
                    limit=collective_wait_limit(opname))
                gathered = {r: self.inbox.pop((rnd, r, "c", idx))
                            for r in others}
            if sc is not None:
                tw1 = sc.phase("rendezvous", tw)
                if idx > 0:
                    wait_after_first_ns += int((tw1 - tw) * 1e9)
            for r, (got_op, got_k, _) in gathered.items():
                if got_op != opname:
                    err = CollectiveMismatchError(
                        f"rank {r} is in {got_op!r} while this rank is in "
                        f"{opname!r} on the same communicator")
                    ctx.fail(err)
                    raise err
                if got_k != K:
                    err = MPIError(
                        f"ranks disagree on the pipeline chunking of "
                        f"{opname!r} ({got_k} vs {K} chunks) — "
                        f"TPU_MPI_PIPELINE_* must be uniform across ranks")
                    ctx.fail(err)
                    raise err
            # fold OUTSIDE the cond hold: the drainer delivers later chunks
            # while this one reduces — that concurrency IS the overlap
            tf = sc.start() if sc is not None else 0.0
            pieces = [arr[lo:hi] if r == rank
                      else np.asarray(_unpack(gathered[r][2], ctx)).reshape(-1)
                      for r in range(n)]
            if (op.ufunc is not None
                    and all(p.dtype == arr.dtype for p in pieces)):
                red = np.empty(hi - lo, dtype=arr.dtype)
                np.copyto(red, pieces[0])
                for p in pieces[1:]:
                    op.ufunc(red, p, out=red)
            else:
                red = np.asarray(_ft.reduce(op, pieces))
            if sc is not None:
                tf1 = sc.phase("fold", tf)
                fold_ns += int((tf1 - tf) * 1e9)
                tf = tf1
            res_parts.append(red)
            for r in others:
                self._send(self.group[r],
                           ("collcres", self.cid, rnd, idx, _pack(red)),
                           opname)
            if sc is not None:
                sc.phase("copy", tf)
            progress_note(prog)
        if sc is not None and _pv.enabled():
            _pv.note_pipelined(self.cid, K, fold_ns, wait_after_first_ns)
        return np.concatenate(res_parts)

    def _run_star(self, rank: int, rnd: int, contrib: Any,
                  combine: Callable[[list[Any]], Sequence[Any]],
                  opname: str) -> Any:
        ctx = self.ctx
        n = len(self.group)
        root_world = self.group[0]
        sc = _pv.scope()    # pvar phase spans; None when pvars+tracing off
        if ctx.local_rank != root_world:
            t0 = sc.start() if sc is not None else 0.0
            self._send(root_world, ("coll", self.cid, rnd, rank, opname,
                                    _pack(contrib)), opname)
            if sc is not None:
                t0 = sc.phase("copy", t0)
            res = self._result_wait(rnd, (rnd,), opname)
            if sc is not None:
                sc.phase("rendezvous", t0)
            return _unpack(res, ctx)

        # root: gather, verify, combine, scatter
        t0 = sc.start() if sc is not None else 0.0
        with self.cond:
            self._wait_for(
                lambda: all((rnd, r) in self.inbox for r in range(n) if r != rank),
                f"collective {opname} (gather)")
            gathered: list[Any] = [None] * n
            for r in range(n):
                if r == rank:
                    gathered[r] = (opname, contrib)
                else:
                    gathered[r] = self.inbox.pop((rnd, r))
        if sc is not None:
            sc.phase("rendezvous", t0)
        names = {op for op, _ in gathered}
        if len(names) > 1:
            err = CollectiveMismatchError(
                f"ranks disagree on the collective for cid {self.cid}: "
                f"{sorted(names)}")
            self.ctx.fail(err)
            raise err
        t0 = sc.start() if sc is not None else 0.0
        try:
            results = list(combine([_unpack(c, ctx) for _, c in gathered]))
        except BaseException as e:
            self.ctx.fail(e)
            raise
        if sc is not None:
            sc.phase("fold", t0)
        if len(results) != n:
            err = MPIError(f"combine for {opname} returned {len(results)} "
                           f"results for {n} ranks")
            self.ctx.fail(err)
            raise err
        t0 = sc.start() if sc is not None else 0.0
        for r in range(n):
            if r == rank:
                continue
            self._send(self.group[r],
                       ("collres", self.cid, rnd, _pack(results[r])), opname)
        if sc is not None:
            sc.phase("copy", t0)
        return results[rank]

    def _send(self, world_dst: int, item: Any, opname: str) -> None:
        """Encode + send a protocol frame (zero-copy for array payloads); an
        unpicklable payload fate-shares with a clear error instead of a raw
        PicklingError mid-protocol (the p2p proxy already guards its
        equivalent case)."""
        try:
            parts = dumps_oob_parts(item, shm_ok=self.ctx.shm_ok(world_dst))
        except OSError as e:
            err = MPIError(
                f"collective {opname} could not stage its payload in the shm "
                f"lane (/dev/shm full or unwritable?): {e}")
            self.ctx.fail(err)
            raise err from None
        except Exception as e:
            err = MPIError(
                f"collective {opname} payload is not picklable and "
                f"multi-process ranks do not share an address space: {e}")
            self.ctx.fail(err)
            raise err from None
        try:
            self.ctx.transport.sendv(world_dst, parts)
        except ConnectionError:
            if self.ctx._detector is None:
                raise
            # failure detection is on: a refused protocol send IS a death
            # signal — surface the typed ULFM error instead of fate-sharing
            self.ctx.peer_failed(world_dst)
            raise ProcFailedError(
                f"rank {world_dst} died mid-collective ({opname})",
                ranks=(world_dst,)) from None

    def _send_batch(self, world_dst: int, items: list, opname: str) -> None:
        """Coalesce a run of protocol frames to one peer into ``("batchv",
        [...])`` wrapper frames (batched submission): each flush is
        ONE framed message — one ``writev`` scatter-gather on the native
        transport, one receiver wakeup — instead of one per item. Grouping
        honors ``config.batch_max_ops`` / ``config.batch_max_bytes``; a cap
        of <= 1 falls back to per-item sends. Array payloads still travel
        out-of-band (``dumps_oob_parts`` encodes the whole wrapper), so the
        zero-copy / shm lanes are unchanged."""
        cfg = config.load()
        cap = int(cfg.batch_max_ops)
        if cap <= 1 or len(items) <= 1:
            for item in items:
                self._send(world_dst, item, opname)
            return
        max_bytes = int(cfg.batch_max_bytes)

        def _nb(item) -> int:
            tail = item[-1]
            return int(getattr(tail, "nbytes", 0) or 0)

        i = 0
        while i < len(items):
            group = [items[i]]
            nbytes = _nb(items[i])
            i += 1
            while i < len(items) and len(group) < cap:
                b = _nb(items[i])
                if max_bytes > 0 and nbytes + b > max_bytes:
                    break
                group.append(items[i])
                nbytes += b
                i += 1
            if len(group) == 1:
                self._send(world_dst, group[0], opname)
            else:
                self._send(world_dst, ("batchv", group), opname)
            if _pv.enabled():
                _pv.note_batch(self.cid, len(group))


class ProcContext(SpmdContext):
    """A world whose ranks are OS processes; this instance represents one.

    `size` is the world size but only ``local_rank`` runs here. Mailbox
    index ``local_rank`` is the real matching engine; all other slots are
    wire proxies. Failure fate-sharing crosses processes via abort frames
    (and the launcher kills the job on any nonzero exit, mpiexec-style).
    """

    def __init__(self, local_rank: int, size: int, transport,
                 universe_size: Optional[int] = None,
                 same_host: Optional[Sequence[bool]] = None,
                 addrs: Optional[Sequence[str]] = None):
        super().__init__(size, universe_size=universe_size)
        self.local_rank = local_rank
        self.transport = transport
        # which peers share this host (shm lane eligibility); default: all,
        # the single-launcher `tpurun --procs` shape.
        self._same_host = tuple(same_host) if same_host is not None \
            else (True,) * size
        # world address table ("host:port" per rank) — the basis for
        # Comm_spawn world growth; empty when unknown (no spawn possible).
        self.addrs: list[str] = list(addrs or [])
        # lazily-cached TPU_MPI_DOMAINS split (see _domain_split)
        self._domain_split_cache: Optional[int] = None
        # snapshot of the debug-sequence flag (read per message on the wire
        # path; a config.load() there would take the config lock per send)
        self.debug_seq = config.load().debug_sequence_check
        # cross-process flow control: peers that told us to stop blocking-
        # sending to them (choke/unchoke frames), and the peers WE choked
        self.choked_by: set[int] = set()
        self.choke_count = 0               # monotonic; see _dispatch "choke"
        self._choke_cond = threading.Condition()
        self._choked_peers: set[int] = set()
        self._choke_high = config.load().send_highwater_bytes
        self._grow_lock = threading.Lock()
        self._spawned_procs: list = []
        self._cid_counter = itertools.count(0)
        self.mailboxes = [
            Mailbox(self) if r == local_rank else _RemoteMailbox(self, r)
            for r in range(size)
        ]
        self._choke_peers_lock = threading.Lock()
        # unchoke decisions are made under the mailbox lock but SENT from
        # the drainer loop (never I/O under the lock that delivers frames)
        self._pending_unchokes: set[int] = set()
        self.mailboxes[local_rank].drain_hook = self._maybe_unchoke
        self.mailboxes[local_rank].pending_recv_hook = self._unchoke_all
        # Blocked-receiver direct drain: one lease on the
        # transport's recv side, shared by the drainer thread and any rank
        # thread blocked in Recv/Wait/Probe. While a receiver waits, the
        # DRAINER IS PARKED (event) and the receiver owns the socket: the
        # message path is sender-process → this thread's own poll(), no
        # drainer→mailbox→scheduler hops and no polling thread competing
        # for the core. ``_last_direct`` keeps the drainer's poll slices
        # short for a grace period after direct activity, so a ping-pong
        # receiver re-entering Recv reclaims the lease without waiting out
        # a full _POLL_MS slice.
        self._pump_lock = threading.Lock()
        self._last_direct = 0.0
        self._direct_waiters = 0
        self._waiters_lock = threading.Lock()
        self._drainer_resume = threading.Event()
        mb = self.mailboxes[local_rank]
        mb.direct_pump = self._direct_pump
        mb.pump_begin = self._pump_begin
        mb.pump_end = self._pump_end
        # Fault-tolerant agreement state (Comm_agree/Comm_shrink substrate):
        # contributions and decisions keyed by ("ftag", cid, epoch). Decisions
        # are kept for the life of the job so a rank that finished an
        # agreement round can answer a straggler's late (re)contribution from
        # its dispatch loop (coordinator-failover correctness).
        self._ft_lock = threading.Lock()
        self._ft_cond = threading.Condition(self._ft_lock)
        self._ft_contribs: dict[Any, dict[int, tuple[int, frozenset]]] = {}
        self._ft_decided: dict[Any, tuple[int, frozenset]] = {}
        # Failure detection (ULFM-shaped fault tolerance): heartbeat frames
        # on the transport poll loop plus a poll-side silence clock. Off by
        # default (heartbeat_ms == 0) — the fault path is pay-for-use.
        # Created BEFORE the drainer starts: the drain loop reads it.
        cfg = config.load()
        self._detector = None
        if cfg.heartbeat_ms > 0 and hasattr(transport, "hb_enable"):
            self._detector = FailureDetector(
                self, transport, cfg.heartbeat_ms, cfg.failure_timeout_ms)
        self._drainer = threading.Thread(target=self._drain, daemon=True,
                                         name="tpu-mpi-drainer")
        self._drainer_stop = threading.Event()
        self._drainer.start()

    @property
    def host_token(self) -> str:
        """Physical-host identity of this rank.

        Derived from the rendezvous address table: ranks whose transport
        addresses share a host part live on one machine and can share POSIX
        shm. ``TPU_MPI_HOST_ID`` overrides it — for NATed networks where
        addresses don't identify machines, and for exercising multi-host
        code paths on one machine. Comm_split_type gathers these tokens
        over the communicator (no rank ever guesses a peer's token) and
        Win_allocate_shared refuses comms that span distinct tokens."""
        override = os.environ.get("TPU_MPI_HOST_ID")
        if override:
            return f"override:{override}"
        if self.addrs:
            return self.addrs[self.local_rank].rsplit(":", 1)[0]
        return "local"

    def _maybe_unchoke(self, queued_bytes: int) -> None:
        """Mailbox drain hook (lock held — no I/O): once the unexpected
        queue falls to the low-water mark, queue every choked sender for an
        unchoke frame; the drainer loop ships them."""
        if queued_bytes > self._choke_high // 2:
            return
        self._unchoke_all()

    def _unchoke_all(self) -> None:
        """Queue unchoke frames for every choked peer (also the
        lock-free-peek fast path: this runs on EVERY posted receive —
        taking the lock with nobody choked is per-message overhead)."""
        if not self._choked_peers:
            return
        self._unchoke_all_locked()

    def _unchoke_all_locked(self) -> None:
        """Queue unchoke frames for every choked peer (also the
        pending-recv hook: a receiver waiting on an unmatched recv may be
        waiting for a choked sender's message — release them all, the
        cross-process analog of the thread tier's posted-receive
        admission bypass)."""
        with self._choke_peers_lock:
            if not self._choked_peers:
                return
            self._pending_unchokes |= self._choked_peers
            self._choked_peers = set()

    def _flush_unchokes(self) -> None:
        """Drainer-loop tail: ship queued unchoke frames. A failed unchoke
        fate-shares — the peer would otherwise hang choked until a
        misleading DeadlockError."""
        if not self._pending_unchokes:     # lock-free peek: hot-path no-op
            return
        with self._choke_peers_lock:
            if not self._pending_unchokes:
                return
            peers, self._pending_unchokes = self._pending_unchokes, set()
        for p in peers:
            try:
                self.send_frame(p, ("unchoke",))
            except Exception as e:
                self.fail(MPIError(
                    f"could not unchoke rank {p}: {type(e).__name__}: {e}"))

    # -- frame transmit -------------------------------------------------------
    def _domain_split(self) -> int:
        """Ranks-per-domain of the ``TPU_MPI_DOMAINS`` world split (0 when
        the override is off or does not divide the world). Cached: procs
        children fix the env before Init and the per-send hot path cannot
        afford a config.load() per frame."""
        spl = self._domain_split_cache
        if spl is None:
            k = int(config.load().domains)
            spl = self.size // k if (2 <= k <= self.size
                                     and self.size % k == 0) else 0
            self._domain_split_cache = spl
        return spl

    def shm_ok(self, world_dst: int) -> bool:
        """Whether the shm lane may carry payloads to this peer: same host
        AND same domain. ``TPU_MPI_DOMAINS`` emulates a multi-host split
        on one box; traffic crossing the emulated host boundary must ride
        the socket fabric, or the "slow inter / fast intra" asymmetry the
        override exists to model would silently vanish."""
        if not (0 <= world_dst < len(self._same_host)
                and self._same_host[world_dst]):
            return False
        spl = self._domain_split()
        return spl == 0 or world_dst // spl == self.local_rank // spl

    def coll_shm_ok(self, group) -> bool:
        """Whether a communicator may use the shared-memory collective fold
        (tune.select's ``shm`` eligibility flag): every member shares this
        host — and this domain, under the ``TPU_MPI_DOMAINS`` emulation —
        and /dev/shm exists. Same-host membership comes from the
        rendezvous address table, so all ranks of a single-host comm agree
        — the rank-uniformity every tier gate requires. A group contained
        in ONE domain keeps the fold (intra-domain sub-comms are exactly
        the fast fabric); a group spanning domains loses it."""
        return (os.path.isdir(_SHM_DIR)
                and all(self.shm_ok(r) for r in group))

    def send_frame(self, world_dst: int, item: Any) -> None:
        send_frame(self.transport, world_dst, item,
                   shm_ok=self.shm_ok(world_dst))

    # -- frame pump -----------------------------------------------------------
    def _handle_frame(self, src_world: int, frame) -> None:
        """Decode + dispatch one received frame (drainer and direct-pump
        shared body; caller holds the pump lease, so frame order is
        preserved across the two entry points)."""
        try:
            fast = _fast_p2p_decode(frame, self)
            item = None if fast is not None else loads_oob(frame)
        except Exception as e:                  # corrupted frame: fate-share
            self.fail(MPIError(f"undecodable frame from {src_world}: {e}"))
            return
        try:
            if fast is not None:
                self._deliver_p2p(src_world, fast)
            else:
                self._dispatch(src_world, item)
        except Exception as e:
            # A failure while dispatching a decoded frame (malformed
            # tuple, error inside deliver/post) must fate-share, not
            # silently kill the drainer thread.
            self.fail(MPIError(
                f"error dispatching frame from {src_world}: "
                f"{type(e).__name__}: {e}"))

    def _pump_begin(self) -> None:
        """A rank thread is entering a blocked receive: park the drainer."""
        with self._waiters_lock:
            self._direct_waiters += 1
            self._drainer_resume.clear()

    def _pump_end(self) -> None:
        with self._waiters_lock:
            self._direct_waiters -= 1
            if self._direct_waiters == 0:
                self._last_direct = time.monotonic()
        # no resume-event set here: waking the drainer per completed receive
        # costs a context switch per message on small-core hosts. The
        # drainer's parked wait has a 50 ms cap, and every blocking wait
        # (P2P and collective) pumps for itself, so nothing depends on the
        # drainer for latency.

    def _direct_pump(self, timeout_s: float, done=None) -> bool:
        """Blocked-receiver drain: poll the transport from the waiting rank
        thread itself (the drainer is parked by _pump_begin). Returns True
        iff a frame was delivered or ``done()`` turned true while acquiring
        the lease (e.g. the drainer delivered our message during its last
        slice); False on idle socket or when a sibling holds the lease."""
        # non-blocking first: the uncontended acquire (the per-message hot
        # case — the drainer is parked) skips the timed-acquire setup cost
        if not self._pump_lock.acquire(False):
            if not self._pump_lock.acquire(timeout=0.001):
                # the drainer holds the lease, possibly blocked deep in its
                # poll slice: ask it to yield (tm_poke -> its non-direct
                # recv returns as a timeout in microseconds), then wait for
                # the handover
                poke = getattr(self.transport, "poke", None)
                if poke is not None:
                    poke()
                if not self._pump_lock.acquire(timeout=timeout_s):
                    return False
        try:
            if done is not None and done():
                return True                 # delivered while we waited
            self._last_direct = time.monotonic()
            if self._detector is not None:
                self._detector.poll()
            self._flush_unchokes()
            try:
                got = self.transport.recv(max(1, int(timeout_s * 1000)),
                                          direct=True)
            except ConnectionResetError:
                return False                    # shutting down
            if got is None:
                return False
            self._handle_frame(*got)
            return True
        finally:
            self._pump_lock.release()

    def _drain(self) -> None:
        while not self._drainer_stop.is_set():
            if self._detector is not None:
                self._detector.poll()
            self._flush_unchokes()
            # park while any rank thread is pumping its own socket — zero
            # CPU from this thread during a blocked receive (the wait has a
            # cap only so stop/failure are still noticed)
            if self._direct_waiters > 0:
                # parked nap, capped at 50 ms. Deliberately NOT woken per
                # completed receive (_pump_end) — that would cost a context
                # switch per message; every blocking wait pumps for itself,
                # so only shutdown() needs to wake us early (it sets the
                # event).
                self._drainer_resume.wait(0.05)
                self._drainer_resume.clear()
                continue
            # grace period after direct activity: the main thread is mid
            # message loop (e.g. between ping-pong Recvs) and will re-take
            # the lease within microseconds — touching the socket here would
            # make it wait out our poll slice. Sleep without the lease;
            # frames sit in the C++ inbox at most this long if the main
            # thread never comes back.
            if time.monotonic() - self._last_direct < 0.02:
                time.sleep(0.005)
                continue
            # recv AND dispatch under one lease hold: releasing between the
            # two would let a direct pumper deliver a later frame first,
            # breaking non-overtaking order
            self._pump_lock.acquire()
            try:
                try:
                    got = self.transport.recv(_POLL_MS)
                except ConnectionResetError:
                    return
                if got is not None:
                    self._handle_frame(*got)
            finally:
                self._pump_lock.release()

    def _deliver_p2p(self, src_world: int, msg: Message) -> None:
        mb = self.mailboxes[self.local_rank]
        mb.post(msg)
        # cross-process flow control: over the mark, tell this sender to
        # pause its BLOCKING sends until we drain (drain_hook unchokes).
        # Record under the lock, ship AFTER releasing it (
        # blocking I/O under a lock _flush_unchokes also takes would let
        # one slow peer socket stall the whole frame pump). Ordering is
        # safe: a concurrently queued unchoke is only flushed at the
        # next drainer-loop top, after this dispatch returns.
        if self._choke_high > 0 and src_world != self.local_rank:
            send_choke = False
            with self._choke_peers_lock:
                if (mb.queued_bytes > self._choke_high
                        and src_world not in self._choked_peers):
                    self._choked_peers.add(src_world)
                    send_choke = True
            if send_choke:
                self.send_frame(src_world, ("choke",))

    def _dispatch(self, src_world: int, item: Any) -> None:
        kind = item[0]
        if kind == "batchv":
            # coalesced submission flush: unwrap in order — sub-frames see
            # exactly the dispatch they would have seen arriving singly
            for sub in item[1]:
                self._dispatch(src_world, sub)
            return
        if kind == "p2p":
            _, src, tag, cid, payload, count, dtype, mkind, seq = item
            self._deliver_p2p(src_world, Message(src, tag, cid,
                                                 _unpack(payload, self), count,
                                                 dtype, mkind, seq=seq))
        elif kind == "choke":
            with self._choke_cond:
                self.choked_by.add(src_world)
                # sticky observability: choked_by empties the instant the
                # receiver unchokes (e.g. it posted a recv), so transient
                # membership is unobservable to a poller — tests and
                # diagnostics read this monotonic counter instead
                self.choke_count += 1
        elif kind == "unchoke":
            with self._choke_cond:
                self.choked_by.discard(src_world)
                self._choke_cond.notify_all()
        elif kind == "coll":
            _, cid, rnd, src, opname, contrib = item
            self._proc_channel(cid).deliver_contrib(rnd, src, opname,
                                                    contrib)
        elif kind == "collres":
            _, cid, rnd, result = item
            self._proc_channel(cid).deliver_result(rnd, result)
        elif kind == "collc":
            _, cid, rnd, src, opname, idx, k, part = item
            self._proc_channel(cid).deliver_chunk(rnd, src, opname, idx, k,
                                                  part)
        elif kind == "collcres":
            _, cid, rnd, idx, result = item
            self._proc_channel(cid).deliver_chunk_result(rnd, idx, result)
        elif kind == "collping":
            # busy probe: is this round still in flight here (e.g. the star
            # root mid-combine)? Answered by the drainer so a long combine
            # on the main thread can't stall the reply.
            _, cid, rnd, src = item
            ch = self._proc_channel(cid)
            with ch.cond:
                busy = rnd in ch.inflight
            self.send_frame(src, ("collpong", cid, rnd, busy))
        elif kind == "collpong":
            _, cid, rnd, busy = item
            ch = self._proc_channel(cid)
            with ch.cond:
                if rnd in ch.probing:   # a late pong nobody waits on is noise
                    ch.inbox[("pong", rnd)] = busy
                    ch.cond.notify_all()
        elif kind == "alg":
            _, cid, rnd, tag, src, opname, payload = item
            self._proc_channel(cid).deliver_alg(rnd, tuple(tag), src, opname,
                                                payload)
        elif kind == "rma":
            from ._rma_wire import dispatch_rma
            dispatch_rma(self, src_world, _unpack(item, None))
        elif kind == "abort":
            _, text = item
            with self._failure_lock:
                if self.failure is None:
                    self.failure = AbortError(text)
            self.mailboxes[self.local_rank].notify()
            for ch in list(self._channels.values()):
                with ch.cond:
                    ch.cond.notify_all()
        elif kind == "revoke":
            # Comm_revoke flood. Re-flood once before marking (dedup via
            # revoked_cids): if the original revoker died mid-flood, every
            # receiver completes the propagation, so all survivors converge.
            _, cid, group = item
            if cid not in self.revoked_cids:
                self.revoke_comm(cid)
                for r in group:
                    if r != self.local_rank and r not in self.failed_ranks:
                        try:
                            self.send_frame(r, ("revoke", cid, tuple(group)))
                        except Exception:
                            pass
        elif kind == "bye":
            # clean Finalize announcement: this peer is about to close its
            # sockets on purpose — the failure detector must not read the
            # resulting EOF as a death (staggered-shutdown false positive)
            self.peer_departed(src_world)
        elif kind == "ftag":
            # agreement contribution (possibly resent after a coordinator
            # failover). If the decision is already known here, answer the
            # straggler directly instead of stashing.
            _, cid, epoch, src, flag, dead = item
            key = ("ftag", cid, epoch)
            with self._ft_cond:
                dec = self._ft_decided.get(key)
                if dec is None:
                    self._ft_contribs.setdefault(key, {})[src] = (
                        int(flag), frozenset(dead))
                    self._ft_cond.notify_all()
            if dec is not None and src != self.local_rank:
                try:
                    self.send_frame(src, ("ftagd", cid, epoch, dec[0],
                                          tuple(sorted(dec[1]))))
                except Exception:
                    pass
        elif kind == "ftagd":
            _, cid, epoch, flag, dead = item
            key = ("ftag", cid, epoch)
            with self._ft_cond:
                self._ft_decided[key] = (int(flag), frozenset(dead))
                self._ft_cond.notify_all()

    # -- fault tolerance (ULFM-shaped: revoke / agree / shrink substrate) -----
    def peer_failed(self, rank: int) -> None:
        if rank in self.failed_ranks:
            return
        super().peer_failed(rank)
        # a dead peer can never unchoke us; drop its choke so blocked
        # senders wake (they re-check failed_ranks and raise typed)
        with self._choke_cond:
            self.choked_by.discard(rank)
            self._choke_cond.notify_all()
        with self._ft_cond:
            self._ft_cond.notify_all()
        self._drainer_resume.set()

    def flood(self, group: Sequence[int], item: Any) -> None:
        """Best-effort broadcast of a control frame to every live member of
        ``group`` (revoke/bye propagation — failures along the way are the
        very condition being handled)."""
        for r in group:
            if r != self.local_rank and r not in self.failed_ranks:
                try:
                    self.send_frame(r, item)
                except Exception:
                    pass

    def drain_failed_state(self, old_cid: Any) -> None:
        """Drop per-communicator state tied to a revoked communicator before
        its shrink replacement goes live: the collective channel (and any
        frames a dead rank parked in its inbox) and the overlap plan cache."""
        with self._channels_lock:
            self._channels.pop(old_cid, None)
        try:
            from .overlap import plans
            plans.invalidate(old_cid)
        except Exception:
            pass

    def ft_agree(self, me: int, group: Sequence[int], cid: Any, epoch: int,
                 flag: int) -> tuple[int, frozenset]:
        """Fault-tolerant agreement round over ``group`` (world ranks).

        Returns ``(value, dead)`` where ``value`` is the bitwise AND of every
        contributing rank's ``flag`` and ``dead`` the union of every
        contributor's failed-set view restricted to the group — the same
        round serves MPI_Comm_agree (callers use the value) and Comm_shrink
        (callers use the dead set).

        Protocol: the lowest-indexed live member of the group coordinates;
        everyone else sends it ``("ftag", ...)`` and waits for the
        ``("ftagd", ...)`` decision. A coordinator death mid-round is
        detected by the heartbeat plane; survivors fail over to the next
        live member and resend. Decisions are remembered for the life of
        the job so late resends are answered from _dispatch even after the
        caller has moved on."""
        group = tuple(group)
        key = ("ftag", cid, epoch)
        deadline = time.monotonic() + deadlock_timeout()
        with self._ft_cond:
            self._ft_contribs.setdefault(key, {})[me] = (
                int(flag), frozenset(self.failed_ranks & set(group)))
        while True:
            if time.monotonic() > deadline:
                raise DeadlockError(
                    f"Comm_agree(cid={cid!r}, epoch={epoch}) did not "
                    f"complete within {deadlock_timeout()}s")
            with self._ft_cond:
                dec = self._ft_decided.get(key)
            if dec is not None:
                return dec
            live = [r for r in group if r not in self.failed_ranks]
            coord = live[0] if live else me
            if coord == me:
                dec = self._ft_coordinate(key, group, deadline)
                for r in group:
                    if r != me and r not in self.failed_ranks:
                        try:
                            self.send_frame(r, ("ftagd", key[1], key[2],
                                                dec[0],
                                                tuple(sorted(dec[1]))))
                        except Exception:
                            pass
                return dec
            # participant: (re)send our contribution to the current
            # coordinator, then wait for a decision or its death
            with self._ft_cond:
                my_flag, my_dead = self._ft_contribs[key][me]
            try:
                self.send_frame(coord, ("ftag", key[1], key[2], me,
                                        my_flag, tuple(sorted(my_dead))))
            except Exception:
                # a refused control send IS a death signal
                self.peer_failed(coord)
                continue
            resend_at = time.monotonic() + 0.5
            with self._ft_cond:
                while (key not in self._ft_decided
                       and coord not in self.failed_ranks
                       and time.monotonic() < resend_at):
                    self._ft_cond.wait(0.02)
                dec = self._ft_decided.get(key)
            if dec is not None:
                return dec
            # coordinator dead or slow: loop (re-elect / resend)

    def _ft_coordinate(self, key: Any, group: tuple[int, ...],
                       deadline: float) -> tuple[int, frozenset]:
        """Coordinator side of ft_agree: wait for every live member's
        contribution (members that die mid-round are excluded as the
        detector marks them), then fold and record the decision."""
        with self._ft_cond:
            while True:
                if key in self._ft_decided:
                    return self._ft_decided[key]
                contribs = self._ft_contribs.get(key, {})
                if all(r in contribs or r in self.failed_ranks
                       for r in group):
                    break
                if time.monotonic() > deadline:
                    raise DeadlockError(
                        f"Comm_agree coordinator (cid={key[1]!r}) timed out "
                        f"waiting for contributions")
                self._ft_cond.wait(0.02)
            value = ~0
            dead = set(self.failed_ranks)
            for f, d in contribs.values():
                value &= f
                dead |= set(d)
            dec = (value, frozenset(dead & set(group)))
            self._ft_decided[key] = dec
            return dec

    # -- channel management ---------------------------------------------------
    def _proc_channel(self, cid: Any) -> ProcChannel:
        with self._channels_lock:
            ch = self._channels.get(cid)
            if ch is None:
                # Drainer can see a contribution before the local rank enters
                # the collective; group is filled in on first local entry but
                # rank-0 routing only needs the cid until then.
                ch = ProcChannel(self, cid, ())
                self._channels[cid] = ch
            return ch

    def channel(self, cid: Any, size: int, group: Optional[tuple[int, ...]] = None):
        if group is None:
            raise MPIError("this communicator type is not supported in "
                           "multi-process mode")
        ch = self._proc_channel(cid)
        if not ch.group:
            ch.group = tuple(group)
        return ch

    def alloc_cid(self):
        """Process-namespaced context ids. alloc_cid runs inside combine(),
        which executes only at the allocating comm's ROOT process — each
        process has its own counter, so two different roots would mint the
        same id (observed: a split-of-a-split deadlocks on the reused
        channel). Tuple of (world rank, local counter): disjoint by
        construction, and — unlike the old size-strided ints — immune to the
        world growing mid-job (Comm_spawn changes self.size, which would
        change the stride and re-collide)."""
        return ("c", self.local_rank, next(self._cid_counter))

    # -- dynamic process management (MPI_Comm_spawn, src/comm.jl:135-147) -----
    def spawn_processes(self, n: int, command, argv, parent_group):
        """Launch ``n`` child OS processes that join this world's transport
        mesh as world ranks [W, W+n) while forming their own COMM_WORLD.
        Runs at the spawning comm's star-root process only (inside combine).
        Returns (child_group, inter_cid, world_cid, world_addrs) — shipped
        to every parent, which then applies the growth locally.

        Concurrent spawns from communicators with different roots are not
        coordinated (no resource-manager universe); the reference delegates
        that to mpiexec's universe."""
        import pickle
        import subprocess
        import tempfile

        from .comm import _worker_argv

        if not self.addrs:
            raise MPIError("Comm_spawn needs the world address table; this "
                           "process was not attached via rendezvous")
        with self._grow_lock:
            base = len(self.addrs)
        child_group = tuple(range(base, base + n))
        inter_cid = self.alloc_cid()
        world_cid = self.alloc_cid()
        if callable(command):
            command_wire: Any = serialization.dumps(command)
        else:
            command_wire = str(command)
        spec = {
            "command": command_wire,
            "argv": [str(a) for a in (argv or [])],
            "worker_argv": _worker_argv(command, argv),
            "parent_group": tuple(parent_group),
            "child_group": child_group,
            "inter_cid": inter_cid,
            "world_cid": world_cid,
        }
        fd, spec_path = tempfile.mkstemp(prefix="tpu_mpi_spawn_", suffix=".pkl")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(spec, f)
        cfg = config.load()
        # bind/advertise like the launcher's coordinator: children run on
        # THIS host, so in a multi-host world their transport addresses must
        # be advertised as this host's routable name, not loopback
        coord = Coordinator(n, host=cfg.coordinator_bind, rank_base=base,
                            base_addrs=list(self.addrs),
                            advertise=cfg.coordinator_advertise or None)
        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        procs = []
        try:
            for i in range(n):
                env = dict(os.environ)
                old_pp = env.get("PYTHONPATH", "")
                env["PYTHONPATH"] = (pkg_parent
                                     + (os.pathsep + old_pp if old_pp else ""))
                env["TPU_MPI_PROC_RANK"] = str(base + i)
                env["TPU_MPI_PROC_SIZE"] = str(base + n)
                env["TPU_MPI_PROC_COORD"] = coord.address
                env["TPU_MPI_SPAWN_SPEC"] = spec_path
                # children inherit the JOB's shm namespace, not the ephemeral
                # spawn-coordinator port, so the launcher's end-of-job sweep
                # reclaims their segments too
                env["TPU_MPI_SHM_TAG"] = shm_job_tag()
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tpu_mpi_torch._spawn_child"], env=env))
            world_addrs = coord.wait_map(config.load().rendezvous_timeout)
        except BaseException:
            for p in procs:
                p.terminate()
            raise
        finally:
            coord.close()
            # every child reads the spec before it rendezvouses, so once the
            # map is (or fails to be) complete the file is dead weight
            try:
                os.unlink(spec_path)
            except OSError:
                pass
        self._spawned_procs.extend(procs)
        return (child_group, inter_cid, world_cid, world_addrs)

    def apply_growth(self, world_addrs: Sequence[str]) -> None:
        """Extend this process's view of the world to the new address table
        (idempotent; every parent rank calls it after a spawn completes)."""
        with self._grow_lock:
            if len(world_addrs) <= len(self.addrs):
                return
            self.transport.grow(list(world_addrs))
            my_host = (self.addrs[self.local_rank].rsplit(":", 1)[0]
                       if self.addrs else "")
            for r in range(len(self.addrs), len(world_addrs)):
                self.mailboxes.append(_RemoteMailbox(self, r))
                self.initialized.append(False)
                self.finalized.append(False)
                self.thread_level.append(None)
                self.main_threads.append(None)
            self._same_host = tuple(
                a.rsplit(":", 1)[0] == my_host for a in world_addrs)
            self.addrs = list(world_addrs)
            self.size = len(world_addrs)

    # -- overrides: shared-address-space features -----------------------------
    def add_ranks(self, n: int, world_cid: Any):
        raise MPIError("internal: thread-tier add_ranks called on the "
                       "multi-process context (use spawn_processes)")

    @property
    def supports_shared_objects(self) -> bool:
        return False

    def device_for(self, rank: int):
        """The card a rank runs on (the thread tier's rule,
        ``cuda:(rank % cards)``): the rank processes of a one-card host are
        that many CUDA contexts on the one card."""
        return torch.device("cuda", rank % torch.cuda.device_count())

    def card(self) -> torch.device:
        """This process's card, where a tensor that left a card in another
        process lands."""
        if not torch.cuda.is_available():
            raise MPIError("a CUDA tensor reached a process that has no CUDA "
                           "device (launch it without --sim, on a host with "
                           "a card)")
        return self.device_for(self.local_rank)

    # -- failure fate-sharing -------------------------------------------------
    def fail(self, exc: BaseException, rank: Optional[int] = None) -> None:
        super().fail(exc, rank)
        text = f"{type(exc).__name__}: {exc}" + (
            f" originating on rank {rank}" if rank is not None else
            f" originating on rank {self.local_rank}")
        frame = pickle.dumps(("abort", text))
        for r in range(self.size):
            if r != self.local_rank:
                try:
                    self.transport.send(r, frame)
                except Exception:
                    pass

    def shutdown(self) -> None:
        # Reap spawned children first: their intercomm traffic rides this
        # process's transport, so stopping it while they still run would
        # strand them (mpiexec waits for the whole universe). One shared
        # 60 s budget; stragglers get SIGTERM, then SIGKILL, and are always
        # wait()ed so nothing stays a zombie.
        import time as _time
        deadline = _time.monotonic() + 60
        for p in self._spawned_procs:
            try:
                p.wait(timeout=max(0.0, deadline - _time.monotonic()))
            except Exception:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except Exception:
                    p.kill()
                    try:
                        p.wait(timeout=5)
                    except Exception:
                        pass
        # Clean departure announcement: with the failure detector active,
        # closing our sockets looks exactly like dying. The "bye" frame
        # tells survivors this EOF is a Finalize, not a failure
        # (staggered-shutdown false-positive suppression).
        if self._detector is not None:
            self.flood(range(self.size), ("bye",))
        self._drainer_stop.set()
        self._drainer_resume.set()      # wake a parked drainer promptly
        self.transport.stop()


# ---------------------------------------------------------------------------
# rendezvous: child side
# ---------------------------------------------------------------------------

def proc_attach() -> tuple[ProcContext, int]:
    """Join the multi-process world described by the TPU_MPI_PROC_* env
    (set by the launcher): start the native transport, rendezvous with the
    coordinator for the address map, and bind this process as its rank.

    The rank runs on its card, ``cuda:(rank % cards)``, made current here,
    unless ``TPU_MPI_PROC_DEVICE=cpu`` (the launcher's ``--sim``) placed it
    on the CPU. A rank that was not placed on the CPU and finds no CUDA
    device fails here rather than running on the CPU."""
    from ._native import NativeTransport

    rank = int(os.environ["TPU_MPI_PROC_RANK"])
    size = int(os.environ["TPU_MPI_PROC_SIZE"])
    coord = os.environ["TPU_MPI_PROC_COORD"]
    host, port = coord.rsplit(":", 1)
    placement = os.environ.get("TPU_MPI_PROC_DEVICE", "cuda")
    if placement != "cpu":
        if not torch.cuda.is_available():
            raise MPIError(
                f"rank {rank} has no CUDA device; launch with --sim to "
                f"place the ranks on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())

    transport = NativeTransport(rank, size)
    with socket.create_connection((host, int(port)), timeout=60) as s:
        # The address map only arrives once ALL siblings have joined; sibling
        # startup skew (native build, cold torch import) routinely exceeds the
        # connect timeout, so wait much longer for the map itself.
        s.settimeout(config.load().rendezvous_timeout)
        s.sendall(json.dumps({"rank": rank, "port": transport.port}).encode()
                  + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            try:
                chunk = s.recv(65536)
            except socket.timeout:
                raise MPIError(
                    f"rendezvous timed out waiting for the world address map "
                    f"(rank {rank}; are all {size} ranks up?)") from None
            if not chunk:
                raise MPIError("coordinator closed during rendezvous")
            buf += chunk
    addrs = json.loads(buf.decode())
    if isinstance(addrs, dict) and "error" in addrs:
        raise MPIError(f"rendezvous failed: {addrs['error']}")
    transport.set_peers(addrs)
    my_host = addrs[rank].rsplit(":", 1)[0]
    same_host = [a.rsplit(":", 1)[0] == my_host for a in addrs]
    # Scheduler-launched jobs have no tpurun parent to sweep crashed ranks'
    # shm segments; reclaim any whose creating process is gone.
    sweep_segments(shm_job_tag(), only_dead_creators=True)
    ctx = ProcContext(rank, size, transport, same_host=same_host, addrs=addrs)
    set_env((ctx, rank))
    # one rank per process: let every thread of it call MPI without the
    # thread-tier's explicit set_env attachment (THREAD_MULTIPLE semantics)
    set_process_env((ctx, rank))
    # Deterministic teardown: stop the drainer + native progress thread at
    # interpreter exit rather than relying on GC-order __del__.
    import atexit
    atexit.register(ctx.shutdown)
    return ctx, rank


# ---------------------------------------------------------------------------
# rendezvous: coordinator (launcher) side
# ---------------------------------------------------------------------------

class Coordinator:
    """Address-map rendezvous server run by the launcher process.

    ``host`` is the bind interface; ``advertise`` is the address children
    dial AND the host loopback-connected children are paired with in the
    world map. For multi-host jobs bind "0.0.0.0" and advertise a routable
    name (config ``coordinator_bind`` / ``coordinator_advertise``)."""

    def __init__(self, nprocs: int, host: str = "127.0.0.1",
                 port: int = 0, advertise: Optional[str] = None,
                 rank_base: int = 0,
                 base_addrs: Optional[list[str]] = None):
        # rank_base/base_addrs: spawn rendezvous (MPI_Comm_spawn) — the
        # ``nprocs`` registrants carry absolute world ranks
        # [rank_base, rank_base+nprocs) and every side receives the FULL
        # world map (existing ranks' addresses + the new ones).
        self.nprocs = nprocs
        self.rank_base = rank_base
        self.base_addrs = list(base_addrs or [])
        self._map: Optional[list[str]] = None
        self._map_ready = threading.Event()
        self.host = host
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(nprocs + 4)
        self.port = self.sock.getsockname()[1]
        if advertise:
            self.advertise_host = advertise
        elif host in ("0.0.0.0", "::", ""):
            self.advertise_host = socket.gethostname()
        else:
            self.advertise_host = host
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.advertise_host}:{self.port}"

    def _serve(self) -> None:
        conns: dict[int, socket.socket] = {}     # rank -> connection
        addrs: dict[int, str] = {}               # rank -> "host:port"
        try:
            while len(conns) < self.nprocs:
                c, peer = self.sock.accept()
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = c.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                try:
                    info = json.loads(buf.decode())
                    rank = int(info["rank"])
                    port = int(info["port"])
                except Exception:
                    c.close()                    # garbled registration
                    continue
                rank -= self.rank_base
                if rank in conns or not (0 <= rank < self.nprocs):
                    # Duplicate or out-of-range rank: reject THIS registrant
                    # with a diagnostic instead of overwriting a sibling's
                    # slot and later dying on a missing rank.
                    try:
                        c.sendall((json.dumps(
                            {"error": f"rendezvous rejected rank {rank}: "
                                      + ("already registered" if rank in conns
                                         else "out of range")}) + "\n").encode())
                    except Exception:
                        pass
                    c.close()
                    continue
                # A child on another host reports its transport port; pair it
                # with the address it connected from (loopback children report
                # the coordinator-visible host).
                chost = (peer[0] if peer[0] not in ("127.0.0.1", "::1")
                         else self.advertise_host)
                addrs[rank] = f"{chost}:{port}"
                conns[rank] = c
            world = self.base_addrs + [addrs[r] for r in range(self.nprocs)]
            payload = (json.dumps(world) + "\n").encode()
            self._map = world
            self._map_ready.set()
            for c in conns.values():
                try:
                    c.sendall(payload)
                finally:
                    c.close()
        except Exception as e:
            # Serve-side failure: tell every connected child so it fails fast
            # instead of blocking out the full rendezvous timeout.
            err = (json.dumps({"error": f"coordinator failed: {e}"}) + "\n").encode()
            for c in conns.values():
                try:
                    c.sendall(err)
                except Exception:
                    pass
                c.close()

    def wait_map(self, timeout: float) -> list[str]:
        """Block until every expected registrant arrived; the full world
        address table (spawn rendezvous: the spawner needs it to grow the
        parents)."""
        if not self._map_ready.wait(timeout):
            raise MPIError(f"spawn rendezvous timed out waiting for "
                           f"{self.nprocs} children")
        assert self._map is not None
        return list(self._map)

    def close(self) -> None:
        try:
            self.sock.close()
        except Exception:
            pass
