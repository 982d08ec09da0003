"""Client side of the serve tier: attach to a broker, run collectives.

A :class:`ClientSession` is what ``MPI.Init(session=...)`` hands back (via
:func:`tpu_mpi_torch.serve.current_session`): one socket to the broker, one
lease (tenant id + rank map + cid-namespace range), and synchronous RPC
collectives on it. Attach is a single HELLO/LEASE round trip — no Init
cold start, which the attach-latency benchmark
(benchmarks/serve_attach.py) quantifies.

Typed broker errors cross the wire: quota breach raises
:class:`~tpu_mpi_torch.error.QuotaExceededError`, backpressure raises the
retriable :class:`~tpu_mpi_torch.error.ServeBusyError`, lease violations raise
:class:`~tpu_mpi_torch.error.SessionError` — the session stays usable after any
of them (reject, don't hang; see docs/serving.md's failure matrix).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

import numpy as np

from .. import config
from .. import locksmith
from .. import tracectx as _tc
from ..error import SessionError
from . import protocol


class SessionComm:
    """A communicator handle inside a session lease: just a cid the broker
    agreed to — all state lives broker-side."""

    __slots__ = ("session", "cid", "nranks")

    def __init__(self, session: "ClientSession", cid: int, nranks: int):
        self.session = session
        self.cid = cid
        self.nranks = nranks

    def __repr__(self) -> str:
        return f"<SessionComm cid={self.cid} nranks={self.nranks}>"


class ClientSession:
    """One tenant's attachment to a broker (use :func:`attach`)."""

    def __init__(self, sock, lease_meta: dict, address: str,
                 attach_trace: Optional[str] = None):
        self._sock = sock
        self._lock = locksmith.make_lock("session.rpc")   # one RPC in flight
        self.address = address
        # the attach handshake's trace id: op root spans link to it so a
        # viewer can hop from any request to the session's route (the
        # router splice/redirect span lives in the ATTACH trace — a
        # splicing router never parses op frames, so per-op router spans
        # cannot exist by design)
        self.attach_trace = attach_trace
        self.tenant: str = lease_meta["tenant"]
        self.ranks: List[int] = list(lease_meta["ranks"])
        self.cid_base: int = int(lease_meta["cid_base"])
        self.cid_limit: int = int(lease_meta["cid_limit"])
        self.attach_us: float = float(lease_meta.get("attach_us", 0.0))
        self.pool: dict = dict(lease_meta.get("pool", {}))
        self.comm = SessionComm(self, int(lease_meta["cid"]),
                                len(self.ranks))
        self._closed = False

    # -- plumbing ------------------------------------------------------------
    def _rpc(self, kind: int, meta: dict, arrays=()) -> tuple:
        with self._lock:
            if self._closed:
                raise SessionError("session is detached")
            try:
                protocol.send_frame(self._sock, kind, meta, arrays)
                rkind, rmeta, rarrays = protocol.recv_frame(self._sock)
            except protocol.Disconnect as e:
                # a vanished broker surfaces as the TYPED session error at
                # the API boundary, and the session knows it is dead — the
                # next call fails fast instead of writing to a corpse
                self._closed = True
                raise SessionError(
                    f"broker at {self.address} hung up mid-session: "
                    f"{e}") from None
        if rkind == protocol.ERROR:
            protocol.raise_for_error(rmeta)
        return rkind, rmeta, rarrays

    def _op(self, meta: dict, arrays=()) -> tuple:
        # trace birth (docs/observability.md "Request traces"): a sampled
        # op mints the trace here and the root span brackets the whole
        # client-observed RPC; every downstream hop parents under it
        ctx, rec = _tc.start_root(f"client:{meta.get('op')}", "client",
                                  tenant=self.tenant,
                                  link=self.attach_trace)
        if ctx is not None:
            meta = dict(meta)
            meta["trace"] = ctx.to_meta()
        try:
            _, rmeta, rarrays = self._rpc(protocol.OP, meta, arrays)
        except BaseException as e:
            _tc.end_span(rec, status="error", error=type(e).__name__)
            raise
        _tc.end_span(rec)
        return rmeta, rarrays

    def _cid(self, comm: Optional[SessionComm]) -> int:
        return (self.comm if comm is None else comm).cid

    # -- collectives ---------------------------------------------------------
    def allreduce(self, parts: Any, op: str = "sum",
                  comm: Optional[SessionComm] = None) -> np.ndarray:
        """Allreduce over the lease's ranks. ``parts`` is either one array
        (every rank contributes it) or a list of one array per rank, numpy
        or torch tensors (a CUDA one crosses by one device-to-host copy);
        the reduced array comes back, as numpy, bitwise identical to an
        in-process deterministic rank-ordered reduction."""
        if isinstance(parts, (list, tuple)):
            arrays = list(parts)
        else:
            arrays = [parts]
        _, out = self._op({"op": "allreduce", "cid": self._cid(comm),
                           "reduce": op}, arrays)
        return out[0]

    def bcast(self, buf: Any, root: int = 0,
              comm: Optional[SessionComm] = None) -> np.ndarray:
        _, out = self._op({"op": "bcast", "cid": self._cid(comm),
                           "root": int(root)}, [buf])
        return out[0]

    def barrier(self, comm: Optional[SessionComm] = None) -> None:
        self._op({"op": "barrier", "cid": self._cid(comm)})

    # -- token generation (tpu_mpi_torch.infer) ------------------------------------
    def generate(self, prompt: Any, max_new: int = 16,
                 on_token=None) -> List[int]:
        """Generate ``max_new`` tokens from an integer ``prompt`` on the
        broker's inference engine, streaming: RESULT frames arrive as the
        engine emits tokens (``on_token(id)`` per token, when given) and
        the full greedy sequence is returned. Typed errors pass through —
        an SLO eviction raises the retriable
        :class:`~tpu_mpi_torch.error.SLOExpiredError`."""
        arr = np.ascontiguousarray(np.asarray(prompt, dtype=np.int32))
        ctx, rec = _tc.start_root("client:generate", "client",
                                  tenant=self.tenant,
                                  link=self.attach_trace)
        op_meta = {"op": "generate", "cid": self.comm.cid,
                   "max_new": int(max_new)}
        if ctx is not None:
            op_meta["trace"] = ctx.to_meta()
        try:
            with self._lock:
                if self._closed:
                    raise SessionError("session is detached")
                protocol.send_frame(self._sock, protocol.OP, op_meta, [arr])
                tokens: List[int] = []
                while True:
                    try:
                        rkind, rmeta, _ = protocol.recv_frame(self._sock)
                    except protocol.Disconnect as e:
                        self._closed = True
                        raise SessionError(
                            f"broker at {self.address} hung up mid-stream: "
                            f"{e}") from None
                    if rkind == protocol.ERROR:
                        protocol.raise_for_error(rmeta)
                    if rkind != protocol.RESULT:
                        raise SessionError(
                            f"expected streamed RESULT, got "
                            f"{protocol.KIND_NAMES.get(rkind, rkind)}")
                    new = [int(t) for t in rmeta.get("tokens", ())]
                    tokens.extend(new)
                    if on_token is not None:
                        for t in new:
                            on_token(t)
                    if rmeta.get("done"):
                        _tc.end_span(rec, tokens=len(tokens))
                        return tokens
        except BaseException as e:
            _tc.end_span(rec, status="error", error=type(e).__name__)
            raise

    # -- communicator management ---------------------------------------------
    def comm_dup(self, comm: Optional[SessionComm] = None) -> SessionComm:
        """Duplicate a communicator; the new cid is allocated inside this
        tenant's leased namespace on the broker."""
        meta, _ = self._op({"op": "dup", "cid": self._cid(comm)})
        return SessionComm(self, int(meta["cid"]), self.comm.nranks)

    def comm_free(self, comm: SessionComm) -> None:
        self._op({"op": "free", "cid": comm.cid})

    # -- accounting / liveness ------------------------------------------------
    def pcontrol(self, level: int = 2) -> dict:
        """MPI_Pcontrol over the wire: level >= 2 flushes the broker's
        per-tenant ledger from a fresh pvar snapshot."""
        meta, _ = self._op({"op": "pcontrol", "cid": self.comm.cid,
                            "level": int(level)})
        return meta

    def stats(self) -> dict:
        _, meta, _ = self._rpc(protocol.STATS, {})
        return meta

    def ping(self) -> None:
        self._rpc(protocol.PING, {})

    # -- lifecycle -----------------------------------------------------------
    def detach(self) -> None:
        """Clean lease release (the broker reclaims cids and closes the
        tenant's books as detached, not revoked)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                protocol.send_frame(self._sock, protocol.DETACH, {})
                protocol.recv_frame(self._sock)       # BYE
            except (protocol.Disconnect, OSError):
                pass
            finally:
                try:
                    self._sock.close()
                except OSError:
                    pass

    close = detach

    def __enter__(self) -> "ClientSession":
        return self

    def __exit__(self, *exc) -> bool:
        self.detach()
        return False

    def __repr__(self) -> str:
        state = "detached" if self._closed else "attached"
        return (f"<ClientSession {self.tenant!r} {state} "
                f"ranks={self.ranks} cids=[{self.cid_base},"
                f"{self.cid_limit})>")


def attach(address: Optional[str] = None, *, token: Optional[str] = None,
           tenant: Optional[str] = None, nranks: Optional[int] = None,
           timeout: float = 10.0) -> ClientSession:
    """Attach to a running broker and return a live :class:`ClientSession`.

    ``address`` defaults to the ``serve_socket`` knob (TPU_MPI_SERVE_SOCKET)
    and ``token`` to ``session_token`` (TPU_MPI_SESSION_TOKEN). The broker
    answers HELLO with either a LEASE (success) or a typed ERROR frame
    (bad token / max_tenants reached / duplicate tenant id), which is
    re-raised here as the matching exception."""
    cfg = config.load()
    address = address or cfg.serve_socket
    if not address:
        raise SessionError("no broker address: pass attach(address=...) or "
                           "set TPU_MPI_SERVE_SOCKET")
    token = cfg.session_token if token is None else token
    hello: dict = {"token": token}
    if tenant is not None:
        hello["tenant"] = tenant
    if nranks is not None:
        hello["nranks"] = int(nranks)
    # a sampled attach is traced too: ONE context for the whole handshake,
    # kept across the REDIRECT hop so the redirected HELLO carries the
    # same trace_id (the propagation edge tests pin this)
    ctx, rec = _tc.start_root("client:attach", "client")
    if ctx is not None:
        hello["trace"] = ctx.to_meta()
    # one REDIRECT hop allowed: a router in redirect mode answers HELLO
    # with the tenant's home broker and the data path goes direct
    for _hop in range(2):
        sock = protocol.connect(address, timeout=timeout)
        try:
            protocol.send_frame(sock, protocol.HELLO, hello)
            kind, meta, _ = protocol.recv_frame(sock)
        except protocol.Disconnect as e:
            sock.close()
            _tc.end_span(rec, status="error", error="Disconnect")
            raise SessionError(f"broker at {address} hung up during attach: "
                               f"{e}") from None
        if kind == protocol.REDIRECT:
            sock.close()
            address = meta["home"]
            if meta.get("tenant"):       # router-minted id: keep the HRW pin
                hello["tenant"] = meta["tenant"]
            continue
        if kind == protocol.ERROR:
            sock.close()
            _tc.end_span(rec, status="error", error="broker-error")
            protocol.raise_for_error(meta)
        if kind != protocol.LEASE:
            sock.close()
            _tc.end_span(rec, status="error", error="bad-frame")
            raise SessionError(f"expected LEASE, got "
                               f"{protocol.KIND_NAMES.get(kind, kind)}")
        _tc.end_span(rec, hops=_hop + 1)
        return ClientSession(sock, meta, address,
                             attach_trace=ctx.trace_id if ctx else None)
    _tc.end_span(rec, status="error", error="redirect-loop")
    raise SessionError(f"attach followed a REDIRECT to {address} and was "
                       f"redirected again — router loop?")


def attach_many(address: str, tenants: int, *, token: Optional[str] = None,
                nranks: Optional[int] = None, timeout: float = 120.0,
                window: int = 512) -> List[ClientSession]:
    """Attach ``tenants`` sessions to one broker with a pipelined handshake.

    :func:`attach` is one serial HELLO/LEASE round trip per call, so the
    attach rate of a herd is capped by latency.  Here up to ``window``
    handshakes are in flight at once: connect + HELLO are fired ahead and
    LEASE replies are drained FIFO, which is what the connection-count
    scaling lane (benchmarks/serve_scale_sweep.py) uses to storm a broker.
    The address must be the broker itself — REDIRECT answers (a router in
    redirect mode) are a :class:`~tpu_mpi_torch.error.SessionError` here."""
    from collections import deque

    cfg = config.load()
    token = cfg.session_token if token is None else token
    hello: dict = {"token": token}
    if nranks is not None:
        hello["nranks"] = int(nranks)

    sessions: List[ClientSession] = []
    pending: "deque" = deque()               # sockets with HELLO sent

    def _drain_one() -> None:
        sock = pending.popleft()
        try:
            kind, meta, _ = protocol.recv_frame(sock)
        except protocol.Disconnect as e:
            sock.close()
            raise SessionError(f"broker at {address} hung up during "
                               f"pipelined attach: {e}") from None
        if kind == protocol.ERROR:
            sock.close()
            protocol.raise_for_error(meta)
        if kind != protocol.LEASE:
            sock.close()
            raise SessionError(f"pipelined attach expected LEASE, got "
                               f"{protocol.KIND_NAMES.get(kind, kind)}")
        sessions.append(ClientSession(sock, meta, address))

    try:
        for _ in range(int(tenants)):
            sock = protocol.connect(address, timeout=timeout)
            try:
                protocol.send_frame(sock, protocol.HELLO, hello)
            except (protocol.Disconnect, OSError) as e:
                sock.close()
                raise SessionError(f"broker at {address} refused a "
                                   f"pipelined HELLO: {e}") from None
            pending.append(sock)
            while len(pending) >= max(1, int(window)):
                _drain_one()
        while pending:
            _drain_one()
    except BaseException:
        for sock in pending:
            try:
                sock.close()
            except OSError:
                pass
        for s in sessions:
            try:
                s._sock.close()
                s._closed = True
            except OSError:
                pass
        raise
    return sessions
