"""Multi-broker scale-out: the tenant router + fleet stats merge.

``tpurun-torch --serve --router --brokers a,b,...`` runs a thin session-level
proxy in front of N brokers (docs/serving.md "Scale-out"):

    client ──HELLO──▶ router ──HELLO──▶ home broker (HRW by tenant key)
    client ◀═════════ raw byte splice ═════════▶ home broker

- **Assignment** is rendezvous (highest-random-weight) hashing over the
  tenant key: deterministic, and STABLE under broker-list changes — removing
  a broker remaps only the tenants it hosted; every other tenant keeps its
  home (tests/test_serve_scale.py asserts both properties).
- After forwarding the (possibly tenant-injected) HELLO, the router splices
  raw bytes both ways until either side closes — no reframing, no payload
  copies beyond the kernel's, and ``generate`` streams pin to the home
  broker by construction (the whole connection lives there, so infer
  engines shard across brokers with their tenants).
- A STATS probe to the router fans out to every broker and merges the
  reports with :func:`merge_stats`.

Each broker behind a router MUST own a distinct cid shard
(``--shard i/N`` / ``TPU_MPI_SERVE_SHARD``): the shards' cid ranges are
disjoint by construction (serve.ledger.CidShard), which is what lets N
brokers' measured books be summed without a cid ever landing in two
tenants' rows — the cross-broker T208 invariant.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import select
import socket
import threading
import time
from typing import Dict, List, Optional

from .. import config
from .. import locksmith
from .. import tracectx as _tc
from ..error import MPIError, SessionError
from . import protocol


def assign_broker(tenant: str, brokers: List[str]) -> str:
    """Rendezvous (HRW) hash: the broker maximizing sha1(tenant|broker).
    Deterministic for a fixed list; removing a broker remaps ONLY its own
    tenants (the defining HRW property); ties break on the broker string."""
    if not brokers:
        raise MPIError("assign_broker needs at least one broker")
    return max(brokers,
               key=lambda b: (hashlib.sha1(f"{tenant}|{b}".encode())
                              .digest(), b))


def _sum_into(dst: dict, src: dict) -> None:
    """Recursively add numeric leaves of ``src`` into ``dst`` (fleet-total
    merge for counter blocks)."""
    for k, v in (src or {}).items():
        if isinstance(v, bool):
            dst[k] = bool(dst.get(k)) or v
        elif isinstance(v, (int, float)):
            dst[k] = dst.get(k, 0) + v
        elif isinstance(v, dict):
            _sum_into(dst.setdefault(k, {}), v)


def merge_stats(reports: List[dict]) -> dict:
    """Merge N per-broker STATS reports into one fleet view. Counter blocks
    (totals, queue, serve_frame) sum; ledger tenants union — their measured
    books still partition the summed pool totals because each broker
    attributes only cids in its OWN disjoint shard (T208 across brokers).
    A tenant name reused on two brokers keeps both rows, disambiguated as
    ``name@b<i>``."""
    merged: dict = {"brokers": [], "totals": {}, "queue": {},
                    "serve_frame": {},
                    "ledger": {"quota_bytes": 0, "tenants": {},
                               "flushes": 0, "last_flush": None},
                    "tenants_attached": []}
    for i, rep in enumerate(reports):
        if rep.get("error"):
            # an unreachable broker mid-poll: keep its {address, error} row
            # in the fleet view instead of failing the whole merge
            merged["brokers"].append({"address": rep.get("address"),
                                      "error": str(rep.get("error"))})
            continue
        merged["brokers"].append({
            "address": rep.get("address"), "backend": rep.get("backend"),
            "shard": rep.get("shard"), "pool": rep.get("pool"),
            "infer": rep.get("infer"), "elastic": rep.get("elastic"),
            "plan_cache": rep.get("plan_cache")})
        _sum_into(merged["totals"], rep.get("totals") or {})
        _sum_into(merged["serve_frame"], rep.get("serve_frame") or {})
        led = rep.get("ledger") or {}
        merged["ledger"]["quota_bytes"] += int(led.get("quota_bytes") or 0)
        merged["ledger"]["flushes"] += int(led.get("flushes") or 0)
        lf = led.get("last_flush")
        if lf is not None and (merged["ledger"]["last_flush"] is None
                               or lf > merged["ledger"]["last_flush"]):
            merged["ledger"]["last_flush"] = lf
        for t, row in (led.get("tenants") or {}).items():
            key = t if t not in merged["ledger"]["tenants"] else f"{t}@b{i}"
            merged["ledger"]["tenants"][key] = row
        merged["tenants_attached"].extend(rep.get("tenants_attached") or [])
        q = rep.get("queue") or {}
        for k, v in q.items():
            if k == "tenants":
                tq = merged["queue"].setdefault("tenants", {})
                for t, row in (v or {}).items():
                    key = t if t not in tq else f"{t}@b{i}"
                    tq[key] = row
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                merged["queue"][k] = merged["queue"].get(k, 0) + v
    merged["tenants_attached"].sort()
    merged["broker_count"] = len(reports)
    return merged


class Router:
    """The session router daemon. Construct with the broker list, then
    :meth:`start` + :meth:`serve_forever` (or drive :meth:`handle` from
    tests)."""

    def __init__(self, brokers: List[str], socket_spec: Optional[str] = None,
                 *, token: Optional[str] = None, mode: Optional[str] = None):
        if not brokers:
            raise MPIError("Router needs at least one broker socket")
        cfg = config.load()
        mode = mode or cfg.serve_router_mode
        if mode not in ("splice", "redirect"):
            raise MPIError(f"router mode {mode!r} is not 'splice' or "
                           f"'redirect' (TPU_MPI_SERVE_ROUTER_MODE)")
        # splice: transparent byte proxy (clients only ever see the router).
        # redirect: answer HELLO with the home broker and let the client
        # re-dial it — the data path skips the router entirely (the
        # serve_scale_sweep headline lane).
        self.mode = mode
        self.brokers = list(brokers)
        self.token = cfg.session_token if token is None else token
        self._socket_spec = socket_spec
        self._listener: Optional[socket.socket] = None
        self.address: Optional[str] = None
        self._tenant_seq = itertools.count(1)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # observability: tenant -> home broker of every live splice
        self.routes: Dict[str, str] = {}
        self._routes_lock = locksmith.make_lock("router.routes")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._listener, self.address = protocol.listen(self._socket_spec)
        self._listener.settimeout(0.2)

    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self.handle, args=(conn,),
                                 name="serve-route", daemon=True)
            t.start()
            self._threads.append(t)

    def run_in_thread(self) -> threading.Thread:
        self.start()
        t = threading.Thread(target=self.serve_forever, name="serve-router",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    # -- per-connection ------------------------------------------------------
    def handle(self, conn: socket.socket) -> None:
        try:
            kind, meta, arrays = protocol.recv_frame(conn)
        except (protocol.Disconnect, SessionError):
            conn.close()
            return
        try:
            if kind == protocol.STATS:
                self._handle_stats(conn, meta)
                return
            if kind == protocol.METRICS:
                self._handle_metrics(conn, meta)
                return
            if kind != protocol.HELLO:
                protocol.send_frame(conn, protocol.ERROR, protocol.error_meta(
                    SessionError(f"router expects HELLO or STATS, got "
                                 f"{protocol.KIND_NAMES.get(kind, kind)}")))
                return
            self._handle_hello(conn, meta, arrays)
        except (protocol.Disconnect, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_stats(self, conn, meta: dict) -> None:
        from .broker import _stats_client
        token = meta.get("token")
        reports = []
        for b in self.brokers:
            try:
                reports.append(_stats_client(b, token))
            except (MPIError, OSError) as e:
                reports.append({"address": b, "error": str(e)})
        protocol.send_frame(conn, protocol.STATS, merge_stats(reports))

    def _handle_metrics(self, conn, meta: dict) -> None:
        """Fleet Prometheus scrape: every broker's METRICS text, joined
        (an unreachable broker becomes a comment line, not a failure)."""
        from .broker import _metrics_client
        token = meta.get("token")
        parts = []
        for b in self.brokers:
            try:
                parts.append(_metrics_client(b, token))
            except (MPIError, OSError) as e:
                parts.append(f"# {b} unreachable: {e}\n")
        protocol.send_frame(conn, protocol.METRICS, {"text": "".join(parts)})

    def _handle_hello(self, conn, meta: dict, arrays: list) -> None:
        # the session key IS the tenant id; a keyless HELLO gets a router-
        # generated one so its home is stable for the connection's lifetime
        meta = dict(meta)
        tenant = meta.get("tenant") or f"rt{next(self._tenant_seq)}"
        meta["tenant"] = tenant
        # request tracing: the HELLO's trace context passes through the hop
        # untouched (redirect echoes it back, splice forwards it verbatim);
        # the router contributes its own span for the routing decision
        tctx = _tc.TraceCtx.from_meta(meta)
        t0_span = time.perf_counter()
        home = assign_broker(tenant, self.brokers)
        if self.mode == "redirect":
            protocol.send_frame(conn, protocol.REDIRECT,
                                {"home": home, "tenant": tenant})
            if tctx is not None and tctx.sampled:
                _tc.emit_span(tctx, "router:redirect", "router", t0_span,
                              time.perf_counter(), tenant=tenant, home=home)
            return
        try:
            upstream = protocol.connect(home)
        except (OSError, MPIError) as e:
            protocol.send_frame(conn, protocol.ERROR, protocol.error_meta(
                SessionError(f"home broker {home} for tenant {tenant!r} "
                             f"unreachable: {e}")))
            return
        if tctx is not None and tctx.sampled:
            _tc.emit_span(tctx, "router:splice", "router", t0_span,
                          time.perf_counter(), tenant=tenant, home=home)
        with self._routes_lock:
            self.routes[tenant] = home
        try:
            protocol.send_frame(upstream, protocol.HELLO, meta, arrays)
            self._splice(conn, upstream)
        finally:
            with self._routes_lock:
                self.routes.pop(tenant, None)
            try:
                upstream.close()
            except OSError:
                pass

    # idle grace for the surviving direction once one side has sent EOF:
    # the deadline re-arms every time that direction moves bytes, so a
    # long in-flight drain is never cut off — this only bounds a peer
    # that has gone silent while half-open
    _HALF_CLOSE_GRACE = 30.0

    @staticmethod
    def _splice(a: socket.socket, b: socket.socket) -> None:
        """Pump raw bytes both ways until BOTH sides finish: past the
        HELLO the router adds no framing and — on the native path — no
        userspace copies at all: each direction is a splice(2) byte pump
        through its own kernel pipe (socket → pipe → socket, transport.cc
        ``tmfd_splice``), with a plain recv/send pump as the portable
        fallback. Half-close is honored: one peer's EOF shuts down only
        the write side it feeds (``shutdown(SHUT_WR)`` on the opposite
        socket) and the reverse direction keeps flowing until its own
        EOF — a client done sending can still drain in-flight replies.
        Runs entirely on the calling handler thread: no pump threads to
        leak, one select loop owns both directions."""
        try:
            from .._native import splice_fd, load as _load_native
            _load_native()             # probe now: no native lib, no splice
        except Exception:
            splice_fd = None

        class _Dir:
            __slots__ = ("src", "dst", "pipe", "native", "open")

            def __init__(self, src, dst):
                self.src, self.dst = src, dst
                self.pipe = None
                self.native = splice_fd is not None
                if self.native:
                    try:
                        self.pipe = os.pipe()
                    except OSError:
                        self.native = False
                self.open = True

        def _py_pump(d) -> int:
            """One fallback pump slice; bytes moved, 0 on EAGAIN, -1 when
            this direction is done."""
            try:
                chunk = d.src.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                return 0
            except OSError:
                return -1
            if not chunk:
                return -1
            view = memoryview(chunk)
            deadline = time.monotonic() + Router._HALF_CLOSE_GRACE
            while view.nbytes:
                try:
                    view = view[d.dst.send(view):]
                except (BlockingIOError, InterruptedError):
                    if not select.select([], [d.dst], [], 1.0)[1] \
                            and time.monotonic() > deadline:
                        return -1       # peer stopped draining: give up
                except OSError:
                    return -1
            return len(chunk)

        def _pump(d) -> int:
            """Bytes moved this slice, 0 on EAGAIN, -1 on EOF/error."""
            if d.native:
                try:
                    moved = splice_fd(d.src.fileno(), d.dst.fileno(),
                                      d.pipe[0], d.pipe[1], 1 << 20)
                except OSError:
                    # EINVAL and friends: this fd pair can't splice —
                    # demote the direction to the userspace pump
                    d.native = False
                    return _py_pump(d)
                if moved == 0:
                    return -1           # 0 = EOF
                return max(moved, 0)    # >0 moved; -1 = EAGAIN
            return _py_pump(d)

        dirs = [_Dir(a, b), _Dir(b, a)]
        for s in (a, b):
            s.setblocking(False)
        first_eof = None
        try:
            while any(d.open for d in dirs):
                rds = [d.src for d in dirs if d.open]
                try:
                    ready = select.select(rds, [], [], 1.0)[0]
                except (OSError, ValueError):
                    break               # a socket died out from under us
                for d in dirs:
                    if not (d.open and d.src in ready):
                        continue
                    moved = _pump(d)
                    if moved < 0:
                        d.open = False
                        try:            # propagate EOF, read side stays up
                            d.dst.shutdown(socket.SHUT_WR)
                        except OSError:
                            pass
                    elif moved and first_eof is not None:
                        # the surviving direction is still draining: re-arm
                        # the grace so it bounds idleness, not total
                        # half-open lifetime
                        first_eof = time.monotonic()
                if any(d.open for d in dirs) != all(d.open for d in dirs):
                    if first_eof is None:
                        first_eof = time.monotonic()
                    elif time.monotonic() - first_eof > \
                            Router._HALF_CLOSE_GRACE:
                        break           # idle lame-duck half: bounded wait
        finally:
            for d in dirs:
                if d.pipe is not None:
                    for fd in d.pipe:
                        try:
                            os.close(fd)
                        except OSError:
                            pass
            for s in (a, b):
                try:
                    s.close()
                except OSError:
                    pass
