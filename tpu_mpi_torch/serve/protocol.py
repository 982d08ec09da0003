"""Session protocol: the framed wire format of the serve tier.

One frame = fixed header + JSON metadata + zero or more raw array blobs:

    u8  kind        (frame type, table below)
    u32 json_len    (big-endian)
    u16 nblobs
    json_len bytes  UTF-8 JSON metadata
    nblobs x { u32 blob_len, blob_len raw bytes }

Arrays travel as raw little-endian bytes with dtype/shape carried in the
metadata (``meta["blobs"]``), reconstructed with ``np.frombuffer`` — the
round trip is bitwise exact, which the two-tenant correctness test in
tests/test_serve.py asserts end-to-end.

Frame types (docs/serving.md has the full table):

    HELLO   client/worker -> broker   token, tenant, nranks (or role=worker)
    LEASE   broker -> client          tenant id, rank map, cid range
    OP      either direction          a collective / comm-management op
    RESULT  broker/worker -> peer     op completion + result arrays
    ERROR   broker -> client          typed failure (code + message)
    STATS   both                      per-tenant usage report request/reply
    DETACH  client -> broker          clean lease release
    BYE     broker -> client          lease revoked / broker shutting down
    PING/PONG both                    liveness probe

The transport is any SOCK_STREAM socket — TCP or Unix-domain; framing and
byte order match the native transport's length-prefixed style
(tpu_mpi_torch/_native/transport.cc) so a future C++ fast path can speak it.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Optional, Sequence

import numpy as np

from .. import error as _ec
from ..error import (MPIError, PoolDegradedError, QuotaExceededError,
                     ServeBusyError, SessionError, SLOExpiredError)

# frame kinds
HELLO = 1
LEASE = 2
OP = 3
RESULT = 4
ERROR = 5
STATS = 6
DETACH = 7
BYE = 8
PING = 9
PONG = 10
REDIRECT = 11      # router -> client: re-dial your home broker directly
METRICS = 12       # both: Prometheus-text exposition request/reply

KIND_NAMES = {HELLO: "HELLO", LEASE: "LEASE", OP: "OP", RESULT: "RESULT",
              ERROR: "ERROR", STATS: "STATS", DETACH: "DETACH", BYE: "BYE",
              PING: "PING", PONG: "PONG", REDIRECT: "REDIRECT",
              METRICS: "METRICS"}

_HDR = struct.Struct("!BIH")
_BLOB = struct.Struct("!I")

# Sanity bound for a single frame's JSON section; array blobs are bounded
# by the config max_frame_bytes knob at recv time.
_MAX_JSON = 1 << 24


class Disconnect(Exception):
    """Peer closed the connection at a frame boundary (clean EOF)."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes into ONE preallocated buffer (no chunk-list
    join copy — the receive side of the zero-copy frame path; the returned
    bytearray is what ``np.frombuffer`` views directly)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            raise Disconnect(f"connection lost mid-frame: {e}") from None
        if r == 0:
            if got == 0:
                raise Disconnect("peer closed")
            raise Disconnect("peer closed mid-frame")
        got += r
    return bytes(buf) if n < 64 else buf  # headers: hashable bytes is fine


# Linux IOV_MAX is 1024; stay well under it per sendmsg call.
_IOV_MAX = 512


def _sendmsg_all(sock: socket.socket, parts: list) -> int:
    """Scatter-gather send of a list of bytes-like parts with partial-send
    resumption — the frame path's writev. Returns the number of sendmsg
    syscalls issued (the ``sg_writes`` pvar)."""
    bufs = [p if isinstance(p, memoryview) else memoryview(p)
            for p in parts]
    bufs = [b.cast("B") if b.ndim != 1 or b.format != "B" else b
            for b in bufs if b.nbytes]
    calls = 0
    while bufs:
        try:
            n = sock.sendmsg(bufs[:_IOV_MAX])
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            raise Disconnect(f"send failed: {e}") from None
        calls += 1
        while n:
            if n >= len(bufs[0]):
                n -= len(bufs.pop(0))
            else:
                bufs[0] = bufs[0][n:]
                n = 0
    return calls


def host_array(a: Any) -> np.ndarray:
    """A payload as numpy: a torch tensor crosses as its numpy bits (a
    CUDA one by one device-to-host copy), as a jax array does through
    ``np.asarray`` in the JAX package; anything else through ``np.asarray``."""
    import torch
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            raise MPIError("a bfloat16 tensor has no numpy dtype to cross "
                           "the session protocol as", code=_ec.ERR_TYPE)
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def send_frame(sock: socket.socket, kind: int,
               meta: Optional[dict] = None,
               arrays: Sequence[Any] = ()) -> None:
    """Serialize and send one frame (thread-safety is the caller's: wrap in
    a per-connection send lock when several threads share the socket).

    Zero-copy path (``TPU_MPI_SERVE_ZEROCOPY``, default on): array payloads
    are scatter-gather written straight from their backing buffers via
    ``sendmsg`` — a C-contiguous array (including the ``np.frombuffer``
    views ``recv_frame`` hands the broker) crosses this hop with ZERO
    marshalling copies; only a non-contiguous input pays one
    ``ascontiguousarray`` materialization, counted in the ``serve_frame``
    pvar block (gate: copies/op <= 1)."""
    from .. import config, perfvars
    meta = dict(meta or {})
    views: list = []
    copies = 0
    zc_bytes = 0
    if arrays:
        meta["blobs"] = []
        for a in arrays:
            arr = host_array(a)
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr)
                copies += 1
            else:
                zc_bytes += arr.nbytes
            meta["blobs"].append({"dtype": arr.dtype.str,
                                  "shape": list(arr.shape)})
            views.append(arr)
    payload = json.dumps(meta, separators=(",", ":")).encode()
    if arrays and not config.load().serve_zerocopy:
        # legacy marshal path (the before/after benchmark lane): every
        # payload is flattened to bytes and joined into one send buffer
        parts = [_HDR.pack(kind, len(payload), len(views)), payload]
        for arr in views:
            b = arr.tobytes()
            parts.append(_BLOB.pack(len(b)))
            parts.append(b)
        try:
            sock.sendall(b"".join(parts))
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            raise Disconnect(f"send failed: {e}") from None
        perfvars.note_serve_frame(ops=1, copies=copies + len(views),
                                  sg_writes=0, zc_bytes=0)
        return
    parts = [_HDR.pack(kind, len(payload), len(views)), payload]
    for arr in views:
        parts.append(_BLOB.pack(arr.nbytes))
        parts.append(memoryview(arr).cast("B") if arr.ndim else
                     memoryview(arr.reshape(1)).cast("B"))
    calls = _sendmsg_all(sock, parts)
    if arrays:
        perfvars.note_serve_frame(ops=1, copies=copies, sg_writes=calls,
                                  zc_bytes=zc_bytes)


def decode_blob(raw, desc: Optional[dict]) -> np.ndarray:
    """One received blob as a ``np.frombuffer`` VIEW over its receive
    buffer (typed+shaped when the metadata describes it). Shared by the
    blocking :func:`recv_frame` below and the event-driven front door's
    incremental parser (serve.frontdoor) so both transports reconstruct
    payloads identically."""
    if desc is not None:
        return (np.frombuffer(raw, dtype=np.dtype(desc["dtype"]))
                .reshape(desc["shape"]))
    return np.frombuffer(raw, dtype=np.uint8)


def recv_frame(sock: socket.socket) -> tuple[int, dict, list]:
    """Receive one frame: (kind, meta, arrays). Raises Disconnect on EOF,
    SessionError on a corrupt stream. Each array is a ``np.frombuffer``
    VIEW over the single receive buffer (no join/marshal copy), so
    forwarding it through :func:`send_frame` keeps the whole
    session-socket -> rank-mailbox hop copy-free."""
    from .. import config
    kind, json_len, nblobs = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if kind not in KIND_NAMES or json_len > _MAX_JSON:
        raise SessionError(f"corrupt session frame (kind={kind}, "
                           f"json_len={json_len})")
    meta = json.loads(bytes(_recv_exact(sock, json_len)).decode()) \
        if json_len else {}
    max_blob = config.load().max_frame_bytes
    arrays = []
    descs = meta.get("blobs") or []
    for i in range(nblobs):
        (blen,) = _BLOB.unpack(_recv_exact(sock, _BLOB.size))
        if blen > max_blob:
            raise SessionError(f"session frame blob of {blen} bytes exceeds "
                               f"max_frame_bytes={max_blob}")
        raw = _recv_exact(sock, blen)
        arrays.append(decode_blob(raw, descs[i] if i < len(descs) else None))
    return kind, meta, arrays


def error_meta(exc: BaseException) -> dict:
    """ERROR-frame metadata for an exception (typed errors keep their code,
    retriability, and structured attributes across the wire)."""
    meta = {"code": int(getattr(exc, "code", _ec.ERR_OTHER)),
            "type": type(exc).__name__,
            "message": str(getattr(exc, "args", [exc])[0]) if exc.args
                       else str(exc),
            "retriable": bool(getattr(exc, "retriable", False))}
    for attr in ("tenant", "used", "quota", "depth", "rid", "slo_ms",
                 "dead", "headroom"):
        v = getattr(exc, attr, None)
        if v is not None:
            meta[attr] = v
    return meta


def raise_for_error(meta: dict) -> None:
    """Reconstruct the typed exception an ERROR frame carries and raise it."""
    code = int(meta.get("code", _ec.ERR_OTHER))
    msg = meta.get("message", "broker error")
    if code == _ec.ERR_QUOTA:
        raise QuotaExceededError(msg, tenant=meta.get("tenant"),
                                 used=int(meta.get("used", 0)),
                                 quota=int(meta.get("quota", 0)))
    if code == _ec.ERR_SERVE_BUSY:
        raise ServeBusyError(msg, tenant=meta.get("tenant"),
                             depth=int(meta.get("depth", 0)))
    if code == _ec.ERR_SLO_EXPIRED:
        raise SLOExpiredError(msg, tenant=meta.get("tenant"),
                              rid=meta.get("rid"),
                              slo_ms=int(meta.get("slo_ms", 0)))
    if code == _ec.ERR_POOL_DEGRADED:
        raise PoolDegradedError(msg, tenant=meta.get("tenant"),
                                dead=tuple(meta.get("dead") or ()),
                                headroom=int(meta.get("headroom", 0)))
    if code == _ec.ERR_SESSION:
        raise SessionError(msg)
    raise MPIError(msg, code=code)


def parse_socket_addr(spec: str) -> tuple[str, Any]:
    """Classify a serve-socket spec: a value containing "/" is a Unix-domain
    socket path, otherwise "host:port" TCP. Returns ("unix", path) or
    ("tcp", (host, port)). Malformed values fail loudly (config contract)."""
    if not spec:
        raise MPIError("empty serve socket spec", code=_ec.ERR_ARG)
    if "/" in spec:
        return "unix", spec
    host, sep, port = spec.rpartition(":")
    if not sep or not host:
        raise MPIError(f"serve socket {spec!r} is neither a Unix path "
                       f"(contains '/') nor host:port", code=_ec.ERR_ARG)
    try:
        return "tcp", (host, int(port))
    except ValueError:
        raise MPIError(f"serve socket {spec!r} has a non-integer port",
                       code=_ec.ERR_ARG) from None


def connect(spec: str, timeout: float = 10.0) -> socket.socket:
    """Dial a serve socket spec (client side)."""
    kind, addr = parse_socket_addr(spec)
    if kind == "unix":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(addr)
    else:
        s = socket.create_connection(addr, timeout=timeout)
    s.settimeout(None)
    # latency: a LEASE/RESULT reply is one small write; don't let Nagle
    # hold it hostage to the next frame
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass                                    # AF_UNIX has no TCP options
    return s


# Listen backlog: attach herds arrive in bursts (the front-door scale
# lane dials thousands of sockets per second); a 64-entry backlog drops
# SYNs under that load and the herd sees connection resets, not queueing.
_BACKLOG = 1024


def listen(spec: Optional[str]) -> tuple[socket.socket, str]:
    """Bind + listen on a serve socket spec (broker side). ``None``/"" picks
    a loopback TCP port. Returns (socket, canonical spec clients dial)."""
    if not spec:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        s.listen(_BACKLOG)
        return s, f"127.0.0.1:{s.getsockname()[1]}"
    kind, addr = parse_socket_addr(spec)
    if kind == "unix":
        import os
        try:
            os.unlink(addr)
        except FileNotFoundError:
            pass
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(addr)
        s.listen(_BACKLOG)
        return s, addr
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(addr)
    s.listen(_BACKLOG)
    return s, f"{addr[0]}:{s.getsockname()[1]}"
