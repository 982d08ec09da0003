"""Point-to-point messaging: Send/Recv, nonblocking, persistent and
partitioned requests, probes, and the Wait/Test family.

Reference: MPI.jl src/pointtopoint.jl — Status (:5-79), Request
(:96-99), Probe (:121-127), Iprobe (:138-148), Get_count (:160-167), Send
(:179-200), serialized send (:208-211), Isend (:226-252), Recv!/Recv/recv
(:271-318), Irecv!/irecv (:333-358), Sendrecv! (:376-393), Wait!/Test!/
Waitall!/Testall!/Waitany!/Testany!/Waitsome!/Testsome!/Cancel! (:404-681).
Persistent (MPI_Send_init), partitioned (MPI-4 Psend_init) and the
combined-replace forms go beyond the reference, as in the JAX package.

Port mapping: ranks are threads of one process sharing one CUDA card, and
every destination is a rank thread's :class:`~tpu_mpi_torch._runtime.Mailbox`,
the host matching engine (tags, ANY_SOURCE/ANY_TAG, non-overtaking order,
Probe on unexpected messages). A message on the card is a CUDA tensor
handed from one rank thread to another: no link is crossed, so the data
movement is the send snapshot and the receive copy, both in HBM.

- **Snapshots.** Sends are buffered: the payload is snapshotted when the
  send is posted and the send completes at once. A raw tensor or host
  array is copied by :func:`~tpu_mpi_torch.buffers.to_wire` (one HBM copy
  for a CUDA tensor); a ``DeviceBuffer``'s tensor is posted as it is,
  because the cell copies on write. So after ``Wait`` a received raw
  tensor never shares storage with a sender's tensor, and a received
  ``DeviceBuffer`` may share the sender's tensor, which a later write
  through the sender's cell does not reach. A persistent send snapshots
  at each ``Start``; ``Pready(i)`` snapshots partition i when called.
- **Streams.** Every rank thread launches on the device's default stream,
  so the sender's snapshot is ordered before the receiver's copy.
- **Host crossings.** A CUDA payload crosses to the host only where the
  caller asks: a receive into a numpy buffer (a device-to-host copy,
  which synchronises) and the object forms ``send``/``recv``, which
  pickle: a CUDA tensor inside an object goes through host bytes and
  comes back on the card. ``Get_count`` and ``Probe`` read metadata only.
- **Flow control.** A blocking ``Send`` is admitted against the
  destination's unexpected queue by the payload's ``nbytes``, which a
  CUDA tensor reports like a host array.

Indices returned by Waitany/Waitsome are 0-based (Python), where the
reference's are 1-based (Julia). The persistent collectives of
:mod:`tpu_mpi_torch.collective` (``Allreduce_init`` and friends) share
this module's Start/Wait/Test contract.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from . import serialization as _serialization
from ._runtime import (ANY_SOURCE, ANY_TAG, PROC_NULL, Mailbox, Message,
                       PendingRecv, require_env)
from .buffers import (DeviceBuffer, element_count, extract_array, is_writable,
                      is_wire_snapshot, to_wire, write_flat, write_range)
from .comm import Comm
from .datatypes import Datatype, to_datatype
from . import error as _ec
from . import perfvars as _pv
from .analyze import events as _ev
from .error import MPIError, TruncationError

_POLL = 0.001


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


def Get_source(status: Status) -> int:
    return status.source


def Get_tag(status: Status) -> int:
    return status.tag


def Get_error(status: Status) -> int:
    return status.error


def Get_count(status: Status, T: Any = None) -> int:
    """Element count of the message in units of T (src/pointtopoint.jl:160-167)."""
    if T is None or status.dtype is None:
        return status.count
    want = to_datatype(T)
    nbytes = status.count * status.dtype.size_bytes
    return nbytes // want.size_bytes


def _status_of(msg: Message) -> Status:
    return Status(source=msg.src, tag=msg.tag, count=msg.count, dtype=msg.dtype)


class Request:
    """Handle for a nonblocking operation (src/pointtopoint.jl:96-99).

    Holds a reference to the live buffer (where a completed receive is
    delivered). A send request is complete at creation (buffered send).
    REQUEST_NULL is modeled by a fresh inactive Request.
    """

    __slots__ = ("kind", "buffer", "status", "_pending", "_mailbox", "_count",
                 "_done", "_inactive", "_trace_isend", "_trace_comm",
                 "_trace_want")

    def __init__(self, kind: str = "null", buffer: Any = None,
                 pending: Optional[PendingRecv] = None, mailbox=None,
                 count: Optional[int] = None, status: Optional[Status] = None):
        self.kind = kind              # "send" | "recv" | "null"
        self.buffer = buffer
        self.status = status
        self._pending = pending
        self._mailbox = mailbox
        self._count = count
        # analyze hooks, set only while tracing: the Isend buffer checksum
        # (T206), the comm a traced Irecv records against, its posted
        # (src, tag)
        self._trace_isend = None
        self._trace_comm = None
        self._trace_want = None
        self._done = kind in ("send", "null")
        # True once the completion has been surfaced to the caller: the
        # request then behaves like MPI_REQUEST_NULL (Waitany/Waitsome must
        # not return it again)
        self._inactive = kind == "null"

    def _deliver(self) -> None:
        """Move a matched message into the user buffer (receiver's thread)."""
        pr = self._pending
        assert pr is not None and pr.msg is not None
        msg = pr.msg
        if self.buffer is not None:
            n = element_count(self.buffer)
            if msg.count > (self._count if self._count is not None else n):
                raise TruncationError(
                    f"message of {msg.count} elements truncated to {n}")
            write_flat(self.buffer, msg.payload, msg.count)
        self.status = _status_of(msg)
        self._done = True
        if self._trace_comm is not None:
            if _ev.enabled():
                want, wtag = self._trace_want or (msg.src, msg.tag)
                _ev.record_recv(self._trace_comm, msg, op="Irecv",
                                want=None if want == ANY_SOURCE else want,
                                wtag=None if wtag == ANY_TAG else wtag)
            if _pv.enabled():
                _pv.add_recv(self._trace_comm, Mailbox._nbytes(msg))

    def _cancelled(self) -> None:
        self.buffer = None
        self.status = STATUS_EMPTY
        self._done = True

    def test(self) -> bool:
        """Nonblocking completion check; delivers on match."""
        if self._done:
            return True
        if self.kind == "recv":
            assert self._mailbox is not None and self._pending is not None
            if self._mailbox.test_recv(self._pending):
                if self._pending.cancelled and self._pending.msg is None:
                    self._cancelled()
                else:
                    self._deliver()
                return True
            return False
        return self._done

    def wait(self) -> Status:
        """Block until complete; delivers the payload."""
        if self._inactive:
            return self.status or STATUS_EMPTY
        if not self._done and self.kind == "recv":
            assert self._mailbox is not None and self._pending is not None
            bev = None
            pv_on = _pv.enabled()
            t0 = _pv.monotonic() if pv_on else 0.0
            if self._trace_comm is not None and _ev.enabled():
                pr = self._pending
                bev = _ev.blocked_event(
                    self._trace_comm, "recv", "Wait(Irecv)",
                    peer=None if pr.src == ANY_SOURCE else pr.src, tag=pr.tag)
                _ev.set_blocked(self._mailbox.ctx, bev)
            try:
                msg = self._mailbox.wait_recv(self._pending)
            finally:
                if bev is not None:
                    _ev.clear_blocked(self._mailbox.ctx, bev)
                if pv_on:
                    _pv.add_wait(_pv.monotonic() - t0, comm=self._trace_comm)
            if msg is None:          # cancelled (src/pointtopoint.jl:677-681)
                self._cancelled()
            else:
                self._deliver()
        self._done = True
        return self._consume()

    def _consume(self) -> Status:
        """Surface the completion: clear the buffer root, go inactive."""
        st = self.status or STATUS_EMPTY
        if self._trace_isend is not None:
            # T206: re-checksum the Isend buffer before the root is cleared
            from ._runtime import current_env
            env = current_env()
            if env is not None:
                _ev.check_isend(env[0], self)
        self.buffer = None
        self._inactive = True
        return st

    @property
    def active(self) -> bool:
        return not self._inactive

    def cancel(self) -> None:
        if self.kind == "recv" and not self._done:
            assert self._mailbox is not None and self._pending is not None
            self._mailbox.cancel(self._pending)

    def __repr__(self) -> str:
        return f"<Request {self.kind} done={self._done}>"


REQUEST_NULL = Request()


def _my_mailbox():
    ctx, world_rank = require_env()
    return ctx.mailboxes[world_rank]


def _post(comm: Comm, dest: int, tag: Any, payload: Any, count: int,
          dtype: Optional[Datatype], kind: str, block: bool = False,
          ubuf: Any = None) -> None:
    ctx, _ = require_env()
    ctx.check_failure()
    if ctx.failed_ranks or ctx.revoked_cids:   # fault path is pay-for-use
        ctx.check_fault(comm.cid)
    # tuple tags carry internal lanes (partitioned traffic: ("part", tag));
    # user tags stay ints
    msg = Message(comm.rank(), tag if isinstance(tag, tuple) else int(tag),
                  comm.cid, payload, count, dtype, kind)
    mb = ctx.mailboxes[comm.world_rank_of(dest)]
    traced = _ev.enabled()
    pv_on = _pv.enabled()
    t0 = _pv.monotonic() if pv_on else 0.0
    if traced:
        opname = (("Send" if block else "Isend") if kind == "typed"
                  else ("send" if block else "isend"))
        _ev.record_send(comm, dest, tag, count, dtype, op=opname,
                        buf=ubuf if ubuf is not None else payload)
    if block:
        # flow control for blocking sends: admission-checked against the
        # destination's unexpected queue under its lock
        bev = (_ev.blocked_event(comm, "send", opname, peer=dest, tag=tag)
               if traced else None)
        _ev.set_blocked(ctx, bev)
        try:
            mb.post_blocking(msg, "Send")
        finally:
            _ev.clear_blocked(ctx, bev)
    else:
        mb.post(msg)
    if pv_on:
        _pv.add_send(comm, Mailbox._nbytes(msg),
                     wait_ns=int((_pv.monotonic() - t0) * 1e9) if block else 0)


# ---------------------------------------------------------------------------
# Blocking / nonblocking send
# ---------------------------------------------------------------------------

def _send_typed(buf: Any, dest: int, tag: int, comm: Comm, block: bool) -> None:
    arr0 = extract_array(buf)
    if arr0 is None:
        raise MPIError(f"not a communication buffer: {type(buf).__name__}",
                       code=_ec.ERR_BUFFER)
    count = element_count(buf)
    # a private to_wire snapshot (Sendrecv_replace made it) is posted as
    # it is: re-snapshotting would only copy again
    arr = buf if is_wire_snapshot(buf) else to_wire(buf, count)
    _post(comm, dest, tag, arr, count, to_datatype(arr.dtype), "typed",
          block=block, ubuf=arr0)


def Send(buf: Any, dest: int, tag: int, comm: Comm) -> None:
    """Blocking typed send (src/pointtopoint.jl:179-200); scalars welcome.

    The payload is snapshotted at call time; the call returns once the
    destination's unexpected queue has room (flow control — the rendezvous
    analog; small/first messages complete immediately, libmpi-eager style)."""
    if dest == PROC_NULL:
        return
    _send_typed(buf, dest, tag, comm, block=True)


def Isend(buf: Any, dest: int, tag: int, comm: Comm) -> Request:
    """Nonblocking send (src/pointtopoint.jl:226-239); completes immediately
    — buffered semantics, never subject to the blocking-send flow control
    (an Isend that blocked could deadlock MPI-legal exchange patterns)."""
    if dest == PROC_NULL:
        return Request("null", status=STATUS_EMPTY)
    _send_typed(buf, dest, tag, comm, block=False)
    req = Request("send", buffer=buf, status=STATUS_EMPTY)
    if _ev.enabled():
        _ev.note_isend(req, comm, buf)
    return req


def _send_obj(obj: Any, dest: int, tag: int, comm: Comm, block: bool) -> None:
    if dest == PROC_NULL:
        return
    try:
        # closures/lambdas/local classes travel by value
        # (tpu_mpi_torch.serialization); a CUDA tensor in obj is pickled
        # through host bytes and unpickled back onto the card
        data = _serialization.dumps(obj)
    except Exception:
        # in-process transport: unserializable objects (sockets, locks)
        # travel by reference
        _post(comm, dest, tag, obj, 0, None, "objref", block=block)
        return
    _post(comm, dest, tag, data, len(data), None, "object", block=block)


def send(obj: Any, dest: int, tag: int, comm: Comm) -> None:
    """Serialized-object send (src/pointtopoint.jl:208-211); blocking, so
    subject to the same flow control as Send."""
    _send_obj(obj, dest, tag, comm, block=True)


def isend(obj: Any, dest: int, tag: int, comm: Comm) -> Request:
    """Nonblocking serialized send (src/pointtopoint.jl:249-252); buffered,
    never blocks (see Isend)."""
    _send_obj(obj, dest, tag, comm, block=False)
    return Request("send", status=STATUS_EMPTY)


# ---------------------------------------------------------------------------
# Blocking / nonblocking receive
# ---------------------------------------------------------------------------

def _recv_blocking(comm: Comm, src: int, tag: int, op: str) -> Message:
    """Match-or-wait in one mailbox lock entry (no Request object)."""
    mb = _my_mailbox()
    if _ev.enabled():
        ctx, _ = require_env()
        bev = _ev.blocked_event(comm, "recv", op,
                                peer=None if src == ANY_SOURCE else src, tag=tag)
        _ev.set_blocked(ctx, bev)
        try:
            msg = mb.recv_blocking(int(src), int(tag), comm.cid)
        finally:
            _ev.clear_blocked(ctx, bev)
        _ev.record_recv(comm, msg, op=op,
                        want=None if src == ANY_SOURCE else src,
                        wtag=None if tag == ANY_TAG else int(tag))
    else:
        msg = mb.recv_blocking(int(src), int(tag), comm.cid)
    assert msg is not None            # a blocking receive has no cancel handle
    return msg


def Recv(buf_or_type: Any, src: int, tag: int, comm: Comm,
         status: Optional[Status] = None):
    """``Recv(buf, src, tag, comm) -> Status`` fills an existing buffer
    (ref ``Recv!`` :271-281); ``Recv(T, src, tag, comm) -> (value, Status)``
    receives one scalar of type T (:296-302).

    ``status``: a caller-owned Status to fill IN PLACE and return instead of
    allocating a fresh one per call (mpi4py's ``status=`` shape)."""
    if isinstance(buf_or_type, (type, Datatype)):
        dt = to_datatype(buf_or_type)
        tmp = np.zeros(1, dtype=dt.np_dtype)
        st = Recv(tmp, src, tag, comm, status)
        return (tmp[0].item() if dt.np_dtype.fields is None else tmp[0]), st
    if src == PROC_NULL:
        return Status(source=PROC_NULL, tag=ANY_TAG, count=0)
    pv_on = _pv.enabled()
    t0 = _pv.monotonic() if pv_on else 0.0
    msg = _recv_blocking(comm, src, tag, "Recv")
    if pv_on:
        _pv.add_recv(comm, Mailbox._nbytes(msg),
                     wait_ns=int((_pv.monotonic() - t0) * 1e9))
    n = element_count(buf_or_type)
    if msg.count > n:
        raise TruncationError(
            f"message of {msg.count} elements truncated to {n}")
    write_flat(buf_or_type, msg.payload, msg.count)
    if status is not None:
        status.source = msg.src
        status.tag = msg.tag
        status.error = 0
        status.count = msg.count
        status.dtype = msg.dtype
        return status
    return _status_of(msg)


def Irecv(buf: Any, src: int, tag: int, comm: Comm) -> Request:
    """Nonblocking receive into buf (ref ``Irecv!`` :333-346)."""
    if src == PROC_NULL:
        return Request("null", status=Status(source=PROC_NULL, tag=ANY_TAG))
    mb = _my_mailbox()
    pr = mb.post_recv(int(src), int(tag), comm.cid)
    req = Request("recv", buffer=buf, pending=pr, mailbox=mb,
                  count=element_count(buf))
    if _ev.enabled() or _pv.enabled():
        req._trace_comm = comm
        req._trace_want = (int(src), int(tag))
    return req


def recv(src: int, tag: int, comm: Comm):
    """Blocking serialized-object receive -> (obj, Status)
    (src/pointtopoint.jl:312-318, via Probe + Get_count)."""
    if src == PROC_NULL:
        return None, Status(source=PROC_NULL, tag=ANY_TAG, count=0)
    msg = _recv_blocking(comm, src, tag, "recv")
    return _object_of(msg), _status_of(msg)


def irecv(src: int, tag: int, comm: Comm):
    """Nonblocking object receive -> (flag, obj|None, Status|None)
    (src/pointtopoint.jl:349-358, via Iprobe)."""
    if src == PROC_NULL:
        return (True, None, Status(source=PROC_NULL, tag=ANY_TAG, count=0))
    mb = _my_mailbox()
    msg = mb.probe(int(src), int(tag), comm.cid, block=False)
    if msg is None:
        return (False, None, None)
    pr = mb.post_recv(msg.src, msg.tag, comm.cid)
    got = mb.wait_recv(pr)
    assert got is not None
    if _ev.enabled():
        _ev.record_recv(comm, got, op="irecv",
                        want=None if src == ANY_SOURCE else src,
                        wtag=None if tag == ANY_TAG else int(tag))
    return (True, _object_of(got), _status_of(got))


def _object_of(msg: Message) -> Any:
    if msg.kind == "object":
        return pickle.loads(msg.payload)
    if msg.kind == "objref":
        return msg.payload
    raise MPIError("typed message received with object API; use Recv")


def Sendrecv(sendbuf: Any, dest: int, sendtag: int,
             recvbuf: Any, src: int, recvtag: int, comm: Comm) -> Status:
    """Combined send+receive (ref ``Sendrecv!`` :376-393); deadlock-safe:
    the receive posts first, and the flow-controlled Send always admits a
    message that matches a posted receive."""
    rreq = Irecv(recvbuf, src, recvtag, comm) if src != PROC_NULL else None
    Send(sendbuf, dest, sendtag, comm)
    if rreq is None:
        return Status(source=PROC_NULL, tag=ANY_TAG, count=0)
    return rreq.wait()


# ---------------------------------------------------------------------------
# Probe
# ---------------------------------------------------------------------------

def Probe(src: int, tag: int, comm: Comm) -> Status:
    """Block until a matching message is enqueued (src/pointtopoint.jl:121-127)."""
    if src == PROC_NULL:
        return Status(source=PROC_NULL, tag=ANY_TAG, count=0)
    mb = _my_mailbox()
    bev = None
    if _ev.enabled():
        ctx, _ = require_env()
        bev = _ev.blocked_event(comm, "recv", "Probe",
                                peer=None if src == ANY_SOURCE else src, tag=tag)
        _ev.set_blocked(ctx, bev)
    try:
        msg = mb.probe(int(src), int(tag), comm.cid, block=True)
    finally:
        if bev is not None:
            _ev.clear_blocked(ctx, bev)
    assert msg is not None
    return _status_of(msg)


def Iprobe(src: int, tag: int, comm: Comm):
    """Nonblocking probe -> (flag, Status|None) (src/pointtopoint.jl:138-148)."""
    if src == PROC_NULL:
        return (True, Status(source=PROC_NULL, tag=ANY_TAG, count=0))
    msg = _my_mailbox().probe(int(src), int(tag), comm.cid, block=False)
    if msg is None:
        return (False, None)
    return (True, _status_of(msg))


# ---------------------------------------------------------------------------
# Completion: Wait/Test families (src/pointtopoint.jl:404-681)
# ---------------------------------------------------------------------------

def Wait(req) -> Status:
    """Block until req completes (ref ``Wait!`` :404-416): a P2P, persistent,
    partitioned or collective request."""
    return req.wait()


def Test(req):
    """(done, Status|None) without blocking (ref ``Test!`` :426-442).
    An inactive (already-consumed / null) request tests as done with an
    empty status, like MPI_REQUEST_NULL."""
    if not req.active:
        return (True, req.status or STATUS_EMPTY)
    if req.test():
        return (True, req._consume())
    return (False, None)


def Waitall(reqs: Sequence) -> list:
    """Block until all complete (ref ``Waitall!`` :453-471). A run of
    fast-armed persistent collective rounds completes through batched
    rendezvous submission first (``overlap.waitall_flush``)."""
    from .overlap import waitall_flush
    waitall_flush(reqs)
    return [r.wait() for r in reqs]


def Testall(reqs: Sequence):
    """(all_done, [Status]) — only consumes requests if all are done
    (ref ``Testall!`` :484-506)."""
    if all((not r.active) or r.test() for r in reqs):
        return (True, [r._consume() if r.active else (r.status or STATUS_EMPTY)
                       for r in reqs])
    return (False, [])


def _poll_ready(reqs: Sequence) -> list:
    """Spin (with failure checks) until ≥1 *active* request completes.
    Returns [] when no request is active; raises DeadlockError after the
    runtime's deadlock timeout like every other blocking wait."""
    from ._runtime import deadlock_timeout, raise_deadlock
    ctx, _ = require_env()
    limit = deadlock_timeout()
    deadline = time.monotonic() + limit
    while True:
        if not any(r.active for r in reqs):
            return []
        ready = [i for i, r in enumerate(reqs) if r.active and r.test()]
        if ready:
            return ready
        ctx.check_failure()
        if time.monotonic() > deadline:
            raise_deadlock(
                ctx, f"deadlock suspected: blocked >{limit}s in Waitany/Waitsome")
        time.sleep(_POLL)


def Waitany(reqs: Sequence):
    """(index, Status) of one newly-completed request, 0-based; (None,
    STATUS_EMPTY) when no request is active (ref ``Waitany!`` :520-541,
    which is 1-based and maps MPI_UNDEFINED to 0)."""
    ready = _poll_ready(reqs)
    if not ready:
        return (None, STATUS_EMPTY)
    i = ready[0]
    return (i, reqs[i]._consume())


def Testany(reqs: Sequence):
    """(found, index|None, Status|None); (True, None, STATUS_EMPTY) when no
    request is active (ref ``Testany!`` :557-581)."""
    if not any(r.active for r in reqs):
        return (True, None, STATUS_EMPTY)
    for i, r in enumerate(reqs):
        if r.active and r.test():
            return (True, i, r._consume())
    return (False, None, None)


def Waitsome(reqs: Sequence):
    """(indices, [Status]) of ≥1 newly-completed requests; ([], []) when no
    request is active (ref ``Waitsome!`` :594-624)."""
    ready = _poll_ready(reqs)
    return (ready, [reqs[i]._consume() for i in ready])


def Testsome(reqs: Sequence):
    """(indices, [Status]) of currently-completed active requests
    (ref ``Testsome!`` :635-665)."""
    ready = [i for i, r in enumerate(reqs) if r.active and r.test()]
    return (ready, [reqs[i]._consume() for i in ready])


def Cancel(req) -> None:
    """Cancel a pending receive (ref ``Cancel!`` :677-681)."""
    req.cancel()


# ---------------------------------------------------------------------------
# Persistent requests (MPI_Send_init / MPI_Recv_init / MPI_Start). A
# persistent request binds the (buffer, peer, tag, comm) pattern once and
# Start re-arms it per round — the MPI API shape for fixed-pattern
# exchanges (halo loops, pipeline hops). Each Start performs a full
# Isend/Irecv, so a send snapshots the buffer's contents at each Start.
# ---------------------------------------------------------------------------

class Prequest:
    """Persistent communication request.

    Duck-types the Request completion protocol, so the whole Wait/Test
    family accepts it. Completion returns it to INACTIVE-BUT-REUSABLE
    (MPI semantics: a completed persistent request is not freed); call
    :func:`Start` to re-arm it. The bound buffer stays attached across
    rounds."""

    def __init__(self, make, kind: str, buffer: Any):
        self._make = make           # () -> a live one-shot Request
        self._inner: Optional[Request] = None
        self.kind = kind            # "psend" | "precv"
        self.buffer = buffer
        self.status: Optional[Status] = None

    def start(self) -> "Prequest":
        if self._inner is not None and self._inner.active:
            raise MPIError("Start on an already-active persistent request",
                           code=_ec.ERR_REQUEST)
        self._inner = self._make()
        return self

    @property
    def active(self) -> bool:
        return self._inner is not None and self._inner.active

    def test(self) -> bool:
        if self._inner is None:
            return True
        return self._inner.test()

    def wait(self) -> Status:
        if self._inner is None:
            return self.status or STATUS_EMPTY
        self.status = self._inner.wait()
        self._inner = None          # inactive, ready for the next Start
        return self.status

    def _consume(self) -> Status:
        if self._inner is None:
            return self.status or STATUS_EMPTY
        self.status = self._inner._consume() if self._inner.active \
            else (self._inner.status or STATUS_EMPTY)
        self._inner = None
        return self.status

    def cancel(self) -> None:
        if self._inner is not None:
            self._inner.cancel()

    def __repr__(self) -> str:
        return f"<Prequest {self.kind} active={self.active}>"


def Send_init(buf: Any, dest: int, tag: int, comm: Comm) -> Prequest:
    """Create an inactive persistent send of ``buf`` to ``dest``
    (MPI_Send_init). Arm with :func:`Start`; each round snapshots the
    buffer's CURRENT contents (update it between rounds freely)."""
    return Prequest(lambda: Isend(buf, dest, tag, comm), "psend", buf)


def Recv_init(buf: Any, src: int, tag: int, comm: Comm) -> Prequest:
    """Create an inactive persistent receive into ``buf``
    (MPI_Recv_init). Arm with :func:`Start`."""
    return Prequest(lambda: Irecv(buf, src, tag, comm), "precv", buf)


def Start(req):
    """Arm a persistent or partitioned request (MPI_Start) — P2P
    (Send_init/Recv_init), partitioned (Psend_init/Precv_init), or
    persistent collective (Allreduce_init/Bcast_init/Barrier_init,
    :mod:`tpu_mpi_torch.collective`)."""
    if not hasattr(req, "start"):
        raise MPIError(code=_ec.ERR_REQUEST,
                       msg="Start requires a persistent/partitioned request "
                       "(Send_init/Recv_init/Psend_init/Precv_init/"
                       "Allreduce_init/Bcast_init/Barrier_init)")
    return req.start()


def Startall(reqs: Sequence) -> Sequence:
    """Arm several persistent requests (MPI_Startall). Persistent
    collectives must be started in the same order on every rank (the
    MPI-4 initiation-order rule); a single Startall list in matching
    order satisfies it."""
    for r in reqs:
        Start(r)
    return reqs


def Sendrecv_replace(buf: Any, dest: int, sendtag: int, src: int,
                     recvtag: int, comm: Comm) -> Status:
    """Combined send+receive through ONE buffer (MPI_Sendrecv_replace,
    standard MPI-1). The outgoing data is snapshotted before the receive
    can overwrite it."""
    snap = to_wire(buf, element_count(buf))
    return Sendrecv(snap, dest, sendtag, buf, src, recvtag, comm)


def Isendrecv(sendbuf: Any, dest: int, sendtag: int,
              recvbuf: Any, src: int, recvtag: int, comm: Comm) -> Request:
    """Nonblocking combined send+receive (MPI-4 MPI_Isendrecv). Returns ONE
    request that completes when the receive lands; the send side is
    buffered (Isend semantics) and needs no tracking."""
    rreq = Irecv(recvbuf, src, recvtag, comm) if src != PROC_NULL else \
        Request("null", status=Status(source=PROC_NULL, tag=ANY_TAG))
    if dest != PROC_NULL:
        _send_typed(sendbuf, dest, sendtag, comm, block=False)
    return rreq


def Isendrecv_replace(buf: Any, dest: int, sendtag: int, src: int,
                      recvtag: int, comm: Comm) -> Request:
    """Nonblocking combined send+receive through one buffer (MPI-4
    MPI_Isendrecv_replace). The outgoing data is snapshotted at call time."""
    snap = to_wire(buf, element_count(buf))
    return Isendrecv(snap, dest, sendtag, buf, src, recvtag, comm)


# ---------------------------------------------------------------------------
# Partitioned communication (MPI-4 §4.2). A partitioned send binds one
# buffer split into N equal partitions; the application marks partitions
# ready as it produces them (Pready) and each ships immediately. The
# receive side completes partition by partition (Parrived), so a consumer
# can start on early partitions while later ones are still in flight.
#
# Each partition travels as one ordinary message on the derived tag
# ("part", tag): per-(src, dst, cid) FIFO plus the Start-after-Wait
# contract keeps rounds from interleaving, so no round counter is needed.
# ---------------------------------------------------------------------------

class PartitionedRequest:
    """Partitioned request (Psend_init / Precv_init). Duck-types the Request
    completion protocol, so the whole Wait/Test family accepts it. Like
    persistent requests, completion returns it to inactive-but-reusable."""

    def __init__(self, kind: str, buf: Any, partitions: int, peer: int,
                 tag: int, comm: Comm):
        n = element_count(buf)
        if partitions < 1 or n % partitions != 0:
            raise MPIError(f"buffer of {n} elements cannot split into "
                           f"{partitions} equal partitions",
                           code=_ec.ERR_COUNT)
        if kind == "precv" and (not is_writable(buf) or (
                isinstance(buf, torch.Tensor) and not buf.is_contiguous())):
            # partitions land in place, one range each: refuse before any
            # partition moves rather than halfway through
            raise MPIError("a partitioned receive needs a writable buffer; a "
                           "raw tensor must be contiguous (or pass a "
                           "DeviceBuffer)", code=_ec.ERR_BUFFER)
        self.kind = kind            # "psend" | "precv"
        self.buffer = buf
        self.partitions = partitions
        self.plen = n // partitions
        self.peer = peer
        self.tag = ("part", int(tag))
        self.comm = comm
        self.status: Optional[Status] = None
        self._active = False
        # send side: which partitions were Pready'd this round
        self._ready: set[int] = set()
        # recv side: pending receives + arrived partition payloads
        self._pending: list = []
        self._arrived: dict[int, Any] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "PartitionedRequest":
        if self._active:
            raise MPIError("Start on an already-active partitioned request",
                           code=_ec.ERR_REQUEST)
        self._active = True
        self._ready = set()
        self._arrived = {}
        if self.kind == "precv":
            mb = _my_mailbox()
            self._pending = [
                mb.post_recv(int(self.peer), self.tag, self.comm.cid)
                for _ in range(self.partitions)]
        return self

    @property
    def active(self) -> bool:
        return self._active

    # -- send side -----------------------------------------------------------
    def pready(self, i: int) -> None:
        if self.kind != "psend":
            raise MPIError("Pready on a partitioned receive",
                           code=_ec.ERR_REQUEST)
        if not self._active:
            raise MPIError("Pready before Start", code=_ec.ERR_REQUEST)
        i = int(i)
        if not (0 <= i < self.partitions):
            raise MPIError(f"partition {i} out of range "
                           f"[0, {self.partitions})", code=_ec.ERR_ARG)
        if i in self._ready:
            raise MPIError(f"partition {i} already marked ready",
                           code=_ec.ERR_REQUEST)
        arr = extract_array(self.buffer)
        a, b = i * self.plen, (i + 1) * self.plen
        # snapshot ONLY partition i, now: the buffer may be filled
        # partition by partition after Start
        if isinstance(self.buffer, DeviceBuffer):
            part = arr.reshape(-1)[a:b]       # the cell copies on write
        elif isinstance(arr, torch.Tensor):
            part = arr.reshape(-1)[a:b].clone()
        elif arr.flags.c_contiguous:
            part = np.array(arr.reshape(-1)[a:b], copy=True)
        else:
            part = np.asarray(arr.flat[a:b])
        _post(self.comm, self.peer, self.tag, (i, part), self.plen, None,
              "object", block=False)
        self._ready.add(i)

    # -- recv side -----------------------------------------------------------
    def _accept(self, payload) -> None:
        i, part = payload
        n = int(part.numel() if isinstance(part, torch.Tensor) else part.size)
        if n != self.plen:
            raise MPIError(
                f"partitioned transfer mismatch: sender partition holds {n} "
                f"elements, receiver expects {self.plen} — Psend_init and "
                f"Precv_init must describe the same partitioning",
                code=_ec.ERR_COUNT)
        self._arrived[int(i)] = part

    def _drain_arrivals(self) -> None:
        mb = _my_mailbox()
        traced = _ev.enabled()
        still = []
        for pr in self._pending:
            if mb.test_recv(pr) and pr.msg is not None:
                if traced:
                    _ev.record_recv(self.comm, pr.msg, op="Precv")
                self._accept(pr.msg.payload)
            else:
                still.append(pr)
        self._pending = still

    def parrived(self, i: int) -> bool:
        if self.kind != "precv":
            raise MPIError("Parrived on a partitioned send",
                           code=_ec.ERR_REQUEST)
        self._drain_arrivals()
        if int(i) in self._arrived:
            self._deliver_one(int(i))
            return True
        return False

    def _deliver_one(self, i: int) -> None:
        part = self._arrived.get(i)
        if part is None or part is True:
            return
        write_range(self.buffer, i * self.plen, part.reshape(-1))
        self._arrived[i] = True       # delivered marker

    # -- completion protocol (Wait/Test family) ------------------------------
    def test(self) -> bool:
        if not self._active:
            return True
        if self.kind == "psend":
            return len(self._ready) == self.partitions
        self._drain_arrivals()
        return len(self._arrived) == self.partitions

    def wait(self) -> Status:
        if not self._active:
            return self.status or STATUS_EMPTY
        ctx, _ = require_env()
        if self.kind == "psend":
            # complete once every partition was marked ready (they ship
            # eagerly at Pready time); another thread may still be
            # producing partitions, so poll with the deadlock budget
            from ._runtime import deadlock_timeout
            deadline = time.monotonic() + deadlock_timeout()
            while len(self._ready) < self.partitions:
                ctx.check_failure()
                if time.monotonic() > deadline:
                    raise MPIError(
                        f"Wait on partitioned send with only "
                        f"{len(self._ready)}/{self.partitions} partitions "
                        f"marked ready", code=_ec.ERR_PENDING)
                time.sleep(0.0005)
            self.status = STATUS_EMPTY
        else:
            mb = _my_mailbox()
            traced = _ev.enabled()
            cancelled = False
            for pr in self._pending:
                msg = mb.wait_recv(pr)
                if msg is None:               # receive was cancelled
                    cancelled = True
                    continue
                if traced:
                    _ev.record_recv(self.comm, msg, op="Precv")
                self._accept(msg.payload)
            self._pending = []
            if cancelled and len(self._arrived) < self.partitions:
                self.status = STATUS_EMPTY
                self._active = False
                return self.status
            for i in range(self.partitions):
                self._deliver_one(i)
            self.status = Status(source=int(self.peer), tag=self.tag[1],
                                 count=self.partitions * self.plen)
        self._active = False
        return self.status

    def _consume(self) -> Status:
        return self.wait() if self._active else (self.status or STATUS_EMPTY)

    def cancel(self) -> None:
        mb = _my_mailbox()
        for pr in self._pending:
            mb.cancel(pr)

    def __repr__(self) -> str:
        return (f"<PartitionedRequest {self.kind} "
                f"{self.partitions}x{self.plen} active={self._active}>")


def Psend_init(buf: Any, partitions: int, dest: int, tag: int,
               comm: Comm) -> PartitionedRequest:
    """Create an inactive partitioned send (MPI-4 MPI_Psend_init): ``buf``
    splits into ``partitions`` equal parts; after :func:`Start`, mark each
    with :func:`Pready` as its data becomes valid — it ships immediately."""
    return PartitionedRequest("psend", buf, int(partitions), dest, tag, comm)


def Precv_init(buf: Any, partitions: int, src: int, tag: int,
               comm: Comm) -> PartitionedRequest:
    """Create an inactive partitioned receive (MPI-4 MPI_Precv_init);
    :func:`Parrived` reports (and delivers) individual partitions before
    the whole request completes. A raw tensor must be contiguous."""
    return PartitionedRequest("precv", buf, int(partitions), src, tag, comm)


def Pready(req: PartitionedRequest, i: int) -> None:
    """Mark partition ``i`` of an active partitioned send ready
    (MPI_Pready); the partition is snapshotted and transferred at once."""
    req.pready(i)


def Pready_range(req: PartitionedRequest, lo: int, hi: int) -> None:
    """Mark partitions [lo, hi] ready (MPI_Pready_range; bounds inclusive
    per the MPI-4 binding)."""
    for i in range(int(lo), int(hi) + 1):
        req.pready(i)


def Parrived(req: PartitionedRequest, i: int) -> bool:
    """Whether partition ``i`` of an active partitioned receive has arrived
    (MPI_Parrived); an arrived partition is delivered into its slice of the
    receive buffer before this returns True."""
    return req.parrived(i)
