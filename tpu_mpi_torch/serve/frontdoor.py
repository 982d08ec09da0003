"""The event-driven session front door: C10k on the native poll engine.

The legacy front door costs one Python thread per attached session — fine
for tens of tenants, a ceiling at thousands (docs/serving.md "Front
door"). This module replaces it with the classic event-driven shape:

    listener ─┐
    session ──┤  edge-triggered readiness loop (1 thread, tmfd_* epoll
    session ──┤  engine in _native/transport.cc; select.epoll fallback)
    session ──┘        │ parsed frames
                  ReadyRing (FIFO across connections, dedup)
                       │
              fixed worker pool (serve_workers threads)
                       │
             the UNCHANGED broker admission path
             (attach_tenant / _serve_op / revoke_lease)

- **One loop thread** owns every socket's read side: it drains readable
  sockets into per-connection incremental frame parsers. An idle attached
  session costs one fd and a parser struct — no thread, no stack.
- **Inbound recv leases**: OP payload blobs land zero-copy in registered
  buffers recycled across frames (the inbound mirror of the outbound
  sendmsg scatter-gather path). A buffer is recycled only when nothing
  views it anymore (BufferError probe), so a payload still referenced by
  an in-flight op can never be clobbered.
- **A fixed worker pool** services complete frames; per-connection order
  is preserved (``busy`` bit — one worker per connection at a time), and
  the pool size bounds frame concurrency while the socket count scales
  independently.
- Writes go through :class:`_SendSock`, a blocking-send facade over the
  nonblocking fd, so ``protocol.send_frame`` and the whole broker reply
  path run unchanged on both transports.

The serve contracts (lease grammar, typed errors, DRR fairness, T208
accounting) are transport-blind: `TPU_MPI_SERVE_TRANSPORT` flips between
this module and the thread-per-connection path, and the same test suite
runs against both.
"""

from __future__ import annotations

import json
import os
import select
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .. import config
from .. import locksmith
from .. import perfvars
from ..error import MPIError, SessionError
from . import protocol
from .queueing import ReadyRing


def _make_engine():
    """The readiness engine: native epoll (tmfd_* in transport.cc) when the
    toolchain can build it, ``select.epoll`` otherwise. Both speak the same
    (fd, bits) event tuples; bit 1 = readable/hangup, bit 2 = writable."""
    try:
        from .._native import NativeFdEngine
        return NativeFdEngine(), "native"
    except Exception:
        return _PyFdEngine(), "python"


class _PyFdEngine:
    """select.epoll fallback mirroring NativeFdEngine's surface (same
    edge-triggered semantics, same wake-pipe cross-thread wakeup)."""

    def __init__(self):
        self._ep = select.epoll()
        self._wake_rd, self._wake_wr = os.pipe()
        os.set_blocking(self._wake_rd, False)
        os.set_blocking(self._wake_wr, False)
        self._ep.register(self._wake_rd, select.EPOLLIN)

    def register(self, fd: int, want_write: bool = False) -> None:
        os.set_blocking(fd, False)
        ev = select.EPOLLIN | select.EPOLLRDHUP | select.EPOLLET
        if want_write:
            ev |= select.EPOLLOUT
        self._ep.register(fd, ev)

    def modify(self, fd: int, want_write: bool) -> None:
        ev = select.EPOLLIN | select.EPOLLRDHUP | select.EPOLLET
        if want_write:
            ev |= select.EPOLLOUT
        self._ep.modify(fd, ev)

    def unregister(self, fd: int) -> None:
        try:
            self._ep.unregister(fd)
        except OSError:
            pass

    def wait(self, timeout: float) -> List[tuple]:
        try:
            events = self._ep.poll(timeout)
        except InterruptedError:
            return []
        out = []
        rd_bits = (select.EPOLLIN | select.EPOLLRDHUP | select.EPOLLHUP
                   | select.EPOLLERR)
        for fd, ev in events:
            if fd == self._wake_rd:
                try:
                    while os.read(self._wake_rd, 256):
                        pass
                except BlockingIOError:
                    pass
                out.append((-1, 0))
                continue
            bits = (1 if ev & rd_bits else 0) | (2 if ev & select.EPOLLOUT
                                                 else 0)
            out.append((fd, bits))
        return out

    def wake(self) -> None:
        try:
            os.write(self._wake_wr, b"\x01")
        except (BlockingIOError, OSError):
            pass                      # a full pipe already holds a wakeup

    def close(self) -> None:
        self._ep.close()
        for fd in (self._wake_rd, self._wake_wr):
            try:
                os.close(fd)
            except OSError:
                pass


class RecvLeasePool:
    """Registered inbound buffers: payload blobs at or under the lease
    window land in a recycled ``bytearray`` (a *hit* — steady-state ops
    allocate nothing on the receive side); larger blobs get a per-frame
    exact-size buffer (a *miss*). Recycling is safe by construction: a
    buffer is reused only when the BufferError probe proves nothing
    exports it anymore (append on a bytearray with live memoryview or
    ndarray exports raises BEFORE mutating) — a stale view can never
    watch its bytes change underneath.

    Returned buffers that still carry exports go to a *quarantine* lane,
    re-probed on later acquires, rather than straight to the GC: the op
    path legitimately outlives the frame by one call — the collective
    auto-arm table (overlap.PlanCache.auto_note) pins each signature's
    most recent operand for its identity streak, releasing it when the
    next op replaces it — so quarantine converts that one-op lag into
    steady-state hits instead of a 100% drop rate."""

    def __init__(self, window: int, capacity: int = 64):
        self.window = max(4096, int(window))
        self.capacity = int(capacity)
        self._free: deque = deque()
        self._quar: deque = deque()
        self._lock = locksmith.make_lock("frontdoor.leasepool")
        self.hits = 0
        self.misses = 0
        self.drops = 0
        self.recycled = 0

    @staticmethod
    def _exported(buf: bytearray) -> bool:
        try:
            buf.append(0)
            buf.pop()
            return False
        except BufferError:
            return True

    def _sweep_locked(self) -> None:
        """Re-probe quarantined buffers; the released ones rejoin the
        freelist (each probed once per sweep)."""
        for _ in range(len(self._quar)):
            buf = self._quar.popleft()
            if self._exported(buf):
                self._quar.append(buf)
            elif len(self._free) < self.capacity:
                self._free.append(buf)
                self.recycled += 1

    def acquire(self, nbytes: int) -> bytearray:
        if nbytes <= self.window:
            with self._lock:
                if not self._free and self._quar:
                    self._sweep_locked()
                if self._free:
                    self.hits += 1
                    return self._free.popleft()
                self.misses += 1
            return bytearray(self.window)
        with self._lock:
            self.misses += 1
        return bytearray(nbytes)

    def recycle(self, buf: bytearray) -> None:
        if len(buf) != self.window:
            return                     # oversize one-shot: GC owns it
        with self._lock:
            if self._exported(buf):
                if len(self._quar) < self.capacity:
                    self._quar.append(buf)
                else:
                    self.drops += 1    # quarantine full: GC owns it
            elif len(self._free) < self.capacity:
                self._free.append(buf)
                self.recycled += 1

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"window": self.window, "hits": self.hits,
                    "misses": self.misses, "drops": self.drops,
                    "recycled": self.recycled,
                    "quarantined": len(self._quar),
                    "hit_rate": (self.hits / total) if total else 0.0}


class _SendSock:
    """Blocking-send facade over a front-door session socket: the loop
    keeps every fd nonblocking (edge-triggered reads), but the broker's
    reply path expects ``sendall``/``sendmsg`` that finish or raise. On
    EAGAIN this parks the *sending worker* in select-for-writability —
    never the event loop. ``close`` routes through the front door so the
    fd leaves the readiness set before it is returned to the kernel (the
    fd-reuse race closes there, not here)."""

    __slots__ = ("_door", "_conn", "_sock")
    _SEND_TIMEOUT = 60.0

    def __init__(self, door: "FrontDoor", conn: "_Conn"):
        self._door = door
        self._conn = conn
        self._sock = conn.sock

    def fileno(self) -> int:
        return self._sock.fileno()

    def _wait_writable(self, deadline: float) -> None:
        remaining = deadline - time.monotonic()
        if remaining <= 0 or not select.select(
                [], [self._sock], [], min(remaining, 5.0))[1]:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "session send stalled: peer is not draining")

    def sendmsg(self, buffers) -> int:
        deadline = time.monotonic() + self._SEND_TIMEOUT
        while True:
            try:
                return self._sock.sendmsg(buffers)
            except BlockingIOError:
                self._wait_writable(deadline)   # lock: blocking

    def sendall(self, data) -> None:
        view = memoryview(data).cast("B")
        deadline = time.monotonic() + self._SEND_TIMEOUT
        while view.nbytes:
            try:
                sent = self._sock.send(view)
                view = view[sent:]
            except BlockingIOError:
                self._wait_writable(deadline)   # lock: blocking

    def close(self) -> None:
        self._door._close_conn(self._conn)

    def getpeername(self):
        return self._sock.getpeername()


# parser stages
_S_HDR, _S_JSON, _S_BLOBLEN, _S_BLOB = range(4)

# per-connection parsed-frame high-water mark: the loop stops feeding a
# connection's parser past this backlog (the legacy thread had natural
# one-frame-at-a-time backpressure; this bounds a pipelining client to a
# fixed number of in-memory frames) and resumes when workers drain below it
_FRAME_HWM = 32


class _Conn:
    """One attached (or attaching) session socket: the incremental frame
    parser the loop thread feeds, the frame queue workers drain, and the
    service bits (``queued`` for the ReadyRing, ``busy`` for per-connection
    order). Only the loop thread touches parser state; workers touch only
    ``frames`` and the service bits (under ``lock``)."""

    __slots__ = ("sock", "fd", "door", "frames", "lock", "queued", "busy",
                 "closed", "dead_read", "paused", "lease", "proxy",
                 "accepted_at",
                 "_stage", "_want", "_got", "_buf", "_view", "_kind",
                 "_json_len", "_nblobs", "_meta", "_blobs", "_bufs",
                 "_blob_i")

    def __init__(self, sock: socket.socket, door: "FrontDoor"):
        self.sock = sock
        self.fd = sock.fileno()
        self.door = door
        self.frames: deque = deque()   # (kind, meta, arrays, bufs) | sentinel
        self.lock = locksmith.make_lock("frontdoor.conn")
        self.queued = False            # owned by the ReadyRing
        self.busy = False              # a worker is servicing this conn
        self.closed = False
        self.dead_read = False         # EOF/corrupt: stop feeding the parser
        self.paused = False            # frame backlog >= _FRAME_HWM
        self.lease = None              # set after a successful attach
        self.proxy = _SendSock(door, self)
        self.accepted_at = time.monotonic()
        self._reset_parser()

    def _reset_parser(self) -> None:
        self._stage = _S_HDR
        self._want = protocol._HDR.size
        self._got = 0
        self._buf = bytearray(self._want)
        self._view = memoryview(self._buf)
        self._kind = 0
        self._json_len = 0
        self._nblobs = 0
        self._meta: dict = {}
        self._blobs: list = []
        self._bufs: list = []
        self._blob_i = 0

    # -- loop-thread side ----------------------------------------------------
    def feed(self) -> int:
        """Drain the socket (edge-triggered: read to EAGAIN), advancing the
        parser; complete frames land in ``self.frames``. Returns the number
        of frames produced. Raises ``protocol.Disconnect`` on EOF and
        ``SessionError`` on a corrupt stream. Stops early (``paused`` set,
        under ``lock``) once the parsed backlog hits ``_FRAME_HWM`` — the
        resume pump in ``FrontDoor._release`` restarts it when workers
        drain below the mark, so a pipelining client holds at most a
        bounded number of frames in memory."""
        produced = 0
        while True:
            if len(self.frames) >= _FRAME_HWM:
                with self.lock:        # recheck: workers drain concurrently
                    if len(self.frames) >= _FRAME_HWM:
                        self.paused = True
                        return produced
            if self._got < self._want:
                try:
                    n = self.sock.recv_into(self._view[self._got:self._want])
                except (BlockingIOError, InterruptedError):
                    return produced
                except OSError as e:
                    raise protocol.Disconnect(
                        f"connection lost mid-frame: {e}") from None
                if n == 0:
                    raise protocol.Disconnect(
                        "peer closed" if self._stage == _S_HDR
                        and self._got == 0 else "peer closed mid-frame")
                self._got += n
                if self._got < self._want:
                    continue
            produced += self._advance()

    def _advance(self) -> int:
        """One completed parser stage; returns 1 when a frame finished."""
        if self._stage == _S_HDR:
            kind, json_len, nblobs = protocol._HDR.unpack(self._buf)
            if kind not in protocol.KIND_NAMES \
                    or json_len > protocol._MAX_JSON:
                raise SessionError(f"corrupt session frame (kind={kind}, "
                                   f"json_len={json_len})")
            self._kind, self._json_len, self._nblobs = kind, json_len, nblobs
            if json_len:
                self._stage = _S_JSON
                self._retarget(bytearray(json_len), json_len)
                return 0
            self._meta = {}
            return self._after_meta()
        if self._stage == _S_JSON:
            try:
                meta = json.loads(bytes(self._buf).decode())
            except (ValueError, UnicodeDecodeError) as e:
                raise SessionError(
                    f"malformed session frame metadata: {e}") from None
            if not isinstance(meta, dict):
                raise SessionError("session frame metadata must be a JSON "
                                   f"object, got {type(meta).__name__}")
            self._meta = meta
            return self._after_meta()
        if self._stage == _S_BLOBLEN:
            (blen,) = protocol._BLOB.unpack(self._buf)
            if blen > config.load().max_frame_bytes:
                raise SessionError(
                    f"session frame blob of {blen} bytes exceeds "
                    f"max_frame_bytes={config.load().max_frame_bytes}")
            buf = self.door.lease_pool.acquire(blen)
            self._bufs.append(buf)
            self._stage = _S_BLOB
            self._retarget(buf, blen)
            return 0
        # _S_BLOB complete: wrap the filled prefix of the lease buffer
        descs = self._meta.get("blobs") or []
        raw = self._view[:self._want]
        desc = descs[self._blob_i] \
            if isinstance(descs, list) and self._blob_i < len(descs) else None
        try:
            blob = protocol.decode_blob(raw, desc if isinstance(desc, dict)
                                        else None)
        except Exception as e:
            # hostile desc (bad dtype string, shape/size mismatch, missing
            # keys): the client's problem, never the loop thread's
            raise SessionError(
                f"malformed session frame blob descriptor: {e}") from None
        self._blobs.append(blob)
        self._blob_i += 1
        return self._next_blob_or_finish()

    def _retarget(self, buf: bytearray, want: int) -> None:
        self._buf = buf
        self._view = memoryview(buf)
        self._want = want
        self._got = 0

    def _after_meta(self) -> int:
        self._blob_i = 0
        return self._next_blob_or_finish()

    def _next_blob_or_finish(self) -> int:
        if self._blob_i < self._nblobs:
            self._stage = _S_BLOBLEN
            self._retarget(bytearray(protocol._BLOB.size),
                           protocol._BLOB.size)
            return 0
        # a frame is a MUTABLE list so _finish_frame can null the payload
        # slots in place — every holder of the frame loses its alias at
        # once, which is what lets the recycle probe succeed. The parser
        # resets before handoff for the same reason: recycling must see
        # only the op path's views, never the parser's leftovers.
        frame = [self._kind, self._meta, self._blobs, self._bufs]
        self._reset_parser()
        self.frames.append(frame)
        return 1


class FrontDoor:
    """The event-driven session transport of one :class:`Broker`
    (``TPU_MPI_SERVE_TRANSPORT=events``): readiness loop + worker pool +
    recv-lease pool, serving the broker's unchanged admission path."""

    _EOF = object()                    # frame-queue sentinel: peer went away

    def __init__(self, broker, listener: socket.socket):
        cfg = config.load()
        self.broker = broker
        self.listener = listener
        self.nworkers = max(1, int(cfg.serve_workers))
        self.lease_pool = RecvLeasePool(int(cfg.serve_lease_window))
        self._engine, self.engine_kind = _make_engine()
        self._conns: Dict[int, _Conn] = {}
        self._conns_lock = locksmith.make_lock("frontdoor.conns")
        self._ready = ReadyRing()
        self._resume: deque = deque()  # paused conns to re-pump (loop drains)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._busy = 0                 # lock: guard frontdoor.conns
        self.started_at = time.monotonic()
        # loop-thread-owned counters (mirrored to pvars as deltas)
        self.wakeups = 0
        self.frames_in = 0
        self.attaches = 0              # worker-updated, under _conns_lock
        self.peak_sockets = 0
        self._mirrored: Dict[str, int] = {}
        self._last_mirror = 0.0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self.listener.setblocking(False)
        self._engine.register(self.listener.fileno())
        for i in range(self.nworkers):
            t = threading.Thread(target=self._worker, name=f"serve-fd-w{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def serve_forever(self) -> None:
        """The readiness loop (the calling thread becomes the loop thread —
        mirrors Broker.serve_forever's blocking contract)."""
        while not self._stop.is_set():
            try:
                events = self._engine.wait(0.2)
            except OSError:
                break
            self.wakeups += 1
            for fd, bits in events:
                if fd < 0:
                    continue           # cross-thread wakeup
                if fd == self.listener.fileno():
                    self._accept_burst()
                    continue
                conn = self._conns.get(fd)
                if conn is None:
                    continue
                self._pump(conn)
            while True:
                try:                   # conns workers un-paused since last
                    conn = self._resume.popleft()   # wait (deque is atomic)
                except IndexError:
                    break
                self._pump(conn)
            now = time.monotonic()
            if now - self._last_mirror >= 1.0:
                self._flush_pvars(now)

    def close(self) -> None:
        self._stop.set()
        self._engine.wake()
        self._ready.close()
        with self._conns_lock:
            conns = list(self._conns.values())
        for conn in conns:
            self._close_conn(conn)
        for t in self._threads:
            t.join(timeout=2.0)
        self._engine.close()

    # -- loop side -----------------------------------------------------------
    def _accept_burst(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self.listener.accept()
            except (BlockingIOError, socket.timeout):
                return
            except OSError:
                return                 # listener closed (broker shutdown)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass                   # AF_UNIX
            conn = _Conn(sock, self)
            with self._conns_lock:
                self._conns[conn.fd] = conn
                n = len(self._conns)
                if n > self.peak_sockets:
                    self.peak_sockets = n
            try:
                self._engine.register(conn.fd)
            except OSError:
                self._close_conn(conn)
                continue
            # data may have raced ahead of registration; pump once by hand
            self._pump(conn)

    def _pump(self, conn: _Conn) -> None:
        if conn.dead_read or conn.closed or conn.paused:
            return
        try:
            produced = conn.feed()
        except Exception:
            # Disconnect/SessionError are the expected stream endings, but
            # a hostile frame can blow up the decode itself in ways no
            # enumeration will ever be complete against — and ANY escape
            # here kills the single loop thread for every attached session.
            # Every flavor means the same thing: this stream is done.
            conn.dead_read = True
            conn.frames.append(self._EOF)
            produced = 1
        self.frames_in += produced
        if produced:
            self._ready.push(conn)

    # -- worker side ---------------------------------------------------------
    def _worker(self) -> None:
        while not self._stop.is_set():
            conn = self._ready.pop(timeout=0.5)
            if conn is None:
                continue
            with conn.lock:
                if conn.busy or not conn.frames:
                    continue
                conn.busy = True
                frame = conn.frames.popleft()
            with self._conns_lock:
                self._busy += 1
            try:
                streaming = self._service(conn, frame)
            except Exception:
                # backstop: _service already maps failures to connection
                # teardown, but a bug (or an exception from the teardown
                # itself) escaping here would kill the pool worker and
                # wedge the conn with busy=True forever — absorb it, drop
                # the one connection, keep the worker.
                streaming = False
                self._drop_conn(conn)
            finally:
                with self._conns_lock:
                    self._busy -= 1
            if not streaming:
                self._release(conn)

    def _drop_conn(self, conn: _Conn) -> None:
        """Best-effort teardown of one session (lease revoked, fd closed);
        never raises — the callers are keep-running paths."""
        if conn.lease is not None:
            try:
                self.broker.revoke_lease(conn.lease, "connection lost",
                                         close_conn=False)
            except Exception:
                pass
        try:
            self._close_conn(conn)
        except Exception:
            pass

    def _release(self, conn: _Conn) -> None:
        """End of one service slice: clear the per-connection busy bit,
        re-enqueue when frames are already waiting, and un-pause the read
        side once the backlog has drained below the high-water mark (the
        loop thread owns the parser, so resuming is a handoff: queue the
        conn and wake the loop)."""
        with conn.lock:
            conn.busy = False
            more = bool(conn.frames) and not conn.closed
            resume = (conn.paused and not conn.closed
                      and len(conn.frames) < _FRAME_HWM)
            if resume:
                conn.paused = False
        if more:
            self._ready.push(conn)
        if resume:
            self._resume.append(conn)
            self._engine.wake()

    def _finish_frame(self, frame: list) -> None:
        """Consume a frame exactly once: null the payload slots in place
        (killing every holder's alias at a stroke) and recycle the lease
        buffers. Safe to call at most once per frame by construction —
        the streaming path takes the frame with it, every other path
        finishes it on the worker."""
        frame[2] = None
        bufs, frame[3] = frame[3], ()
        for buf in bufs:
            self.lease_pool.recycle(buf)

    def _service(self, conn: _Conn, frame) -> bool:
        """Handle ONE parsed frame on a worker; returns True when a
        streaming generation took ownership of the connection (its thread
        will release the busy bit and finish the frame)."""
        broker = self.broker
        if frame is self._EOF:
            if conn.lease is not None:
                broker.revoke_lease(conn.lease, "connection lost",
                                    close_conn=False)
            self._close_conn(conn)
            return False
        kind, meta = frame[0], frame[1]
        handed_off = False
        try:
            if conn.lease is None:
                self._service_preattach(conn, kind, meta)
                return False
            lease = conn.lease
            if kind == protocol.DETACH:
                broker.revoke_lease(lease, "client detached",
                                    close_conn=False)
                protocol.send_frame(conn.proxy, protocol.BYE,
                                    {"tenant": lease.tenant})
                self._close_conn(conn)
                return False
            if kind == protocol.PING:
                with lease.send_lock:
                    protocol.send_frame(conn.proxy, protocol.PONG, {})
                return False
            if kind == protocol.STATS:
                with lease.send_lock:
                    protocol.send_frame(conn.proxy, protocol.STATS,
                                        broker.stats())
                return False
            if kind == protocol.METRICS:
                from .. import stats as _stats
                text = _stats.to_prometheus(broker.stats())
                with lease.send_lock:
                    protocol.send_frame(conn.proxy, protocol.METRICS,
                                        {"text": text})
                return False
            if kind != protocol.OP:
                raise SessionError(
                    f"unexpected {protocol.KIND_NAMES.get(kind, kind)} "
                    f"frame mid-session")
            if meta.get("op") == "generate":
                t = threading.Thread(target=self._stream_generate,
                                     args=(conn, lease, frame),
                                     name="serve-generate", daemon=True)
                t.start()
                handed_off = True
                return True            # the stream thread releases busy
            broker._serve_op(lease, meta, frame[2])
            return False
        except Exception:
            # the legacy thread's teardown semantics, exactly: Disconnect/
            # SessionError/OSError are the expected endings, and any other
            # client-triggered exception (non-numeric cid/nranks, etc.)
            # costs that client its connection — never a pool worker.
            self._drop_conn(conn)
            return False
        finally:
            if not handed_off:
                self._finish_frame(frame)

    def _service_preattach(self, conn: _Conn, kind: int, meta: dict) -> None:
        broker = self.broker
        if kind == protocol.STATS:
            # lease-less admin probe (tpurun-torch --serve --stats)
            try:
                broker._check_token(meta.get("token"))
                protocol.send_frame(conn.proxy, protocol.STATS,
                                    broker.stats())
            except MPIError as e:
                protocol.send_frame(conn.proxy, protocol.ERROR,
                                    protocol.error_meta(e))
            self._close_conn(conn)
            return
        if kind == protocol.METRICS:
            # lease-less Prometheus scrape off the event loop — a fleet
            # scraper needs no session and costs no listener thread
            try:
                broker._check_token(meta.get("token"))
                from .. import stats as _stats
                protocol.send_frame(conn.proxy, protocol.METRICS,
                                    {"text": _stats.to_prometheus(
                                        broker.stats())})
            except MPIError as e:
                protocol.send_frame(conn.proxy, protocol.ERROR,
                                    protocol.error_meta(e))
            self._close_conn(conn)
            return
        if kind != protocol.HELLO:
            protocol.send_frame(conn.proxy, protocol.ERROR,
                                protocol.error_meta(SessionError(
                                    f"expected HELLO, got "
                                    f"{protocol.KIND_NAMES.get(kind, kind)}")))
            self._close_conn(conn)
            return
        t0 = time.perf_counter()
        try:
            lease = broker.attach_tenant(conn.proxy, meta)
        except Exception as e:
            # typed MPIErrors cross the wire as-is; anything else a hostile
            # HELLO can trigger (non-numeric nranks, bad field types) is
            # the client's malformed request, reported as such
            err = e if isinstance(e, MPIError) else SessionError(
                f"malformed HELLO: {type(e).__name__}: {e}")
            protocol.send_frame(conn.proxy, protocol.ERROR,
                                protocol.error_meta(err))
            self._close_conn(conn)
            return
        attach_us = (time.perf_counter() - t0) * 1e6
        conn.lease = lease
        with self._conns_lock:
            self.attaches += 1
        protocol.send_frame(conn.proxy, protocol.LEASE, {
            "tenant": lease.tenant, "ranks": list(lease.group),
            "cid": lease.root_cid,
            "cid_base": lease.ns.base, "cid_limit": lease.ns.limit,
            "pool": broker.pool.info(), "attach_us": attach_us})

    def _stream_generate(self, conn: _Conn, lease, frame: list) -> None:
        """A streaming generation on its own thread: RESULT frames flow for
        the stream's whole life, so parking a pool worker on it would let
        max-workers concurrent streams starve every other session. Threads
        here scale with concurrent *streams*, not with attached sockets."""
        try:
            self.broker._serve_generate(lease, frame[1], frame[2])
        except Exception:
            self._drop_conn(conn)
        finally:
            self._finish_frame(frame)
            self._release(conn)

    # -- close / teardown ----------------------------------------------------
    def _close_conn(self, conn: _Conn) -> None:
        """The only place a session fd dies: deregister from the readiness
        set BEFORE close so the kernel cannot recycle the fd number into a
        new accept while stale events for the old one are still queued."""
        with self._conns_lock:
            if conn.closed:
                return
            conn.closed = True
            self._conns.pop(conn.fd, None)
        conn.dead_read = True
        try:
            self._engine.unregister(conn.fd)
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- observability -------------------------------------------------------
    def _flush_pvars(self, now: float) -> None:
        """Mirror local counters into the process pvar store as deltas (the
        loop owns its counters; pvar dumps and --stats read the mirror)."""
        self._last_mirror = now
        if not perfvars.enabled():
            return
        lp = self.lease_pool.stats()
        with self._conns_lock:
            counts = {"wakeups": self.wakeups, "frames": self.frames_in,
                      "attaches": self.attaches, "lease_hits": lp["hits"],
                      "lease_misses": lp["misses"],
                      "lease_drops": lp["drops"]}
            open_sockets = len(self._conns)
            busy = self._busy
            # delta-vs-mirror and the mirror update must be one atomic
            # step: this runs on the loop thread AND on worker threads
            # (stats() -> broker.stats()), and two callers working from
            # the same baseline would double-count every delta
            deltas = {k: v - self._mirrored.get(k, 0)
                      for k, v in counts.items()}
            deltas = {k: v for k, v in deltas.items() if v}
            if deltas:
                self._mirrored.update(counts)
        if deltas:
            perfvars.note_front_door(**deltas)
        perfvars.set_front_door_gauges(open_sockets=open_sockets,
                                       workers=self.nworkers,
                                       workers_busy=busy)

    def stats(self) -> dict:
        """The front_door block of Broker.stats(): live socket population,
        attach totals, loop wakeups, recv-lease effectiveness, worker-pool
        occupancy."""
        self._flush_pvars(time.monotonic())
        with self._conns_lock:
            open_sockets = len(self._conns)
            busy = self._busy
            attaches = self.attaches
        uptime = max(time.monotonic() - self.started_at, 1e-9)
        return {"engine": self.engine_kind,
                "open_sockets": open_sockets,
                "peak_sockets": self.peak_sockets,
                "attaches": attaches,
                "attach_per_s": attaches / uptime,
                "uptime_s": uptime,
                "wakeups": self.wakeups,
                "frames": self.frames_in,
                "ready_depth": len(self._ready),
                "workers": self.nworkers,
                "workers_busy": busy,
                "recv_lease": self.lease_pool.stats()}
