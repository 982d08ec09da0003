"""The broker-side elastic autoscaler + resize orchestrator.

One controller thread per broker. Every ``TPU_MPI_ELASTIC_INTERVAL_MS`` it
reads four signals — fair-queue depth, busy-rejection backlog, the infer
scheduler's SLO hit rate, and the failure detector — and decides between
three moves:

- **restore** (immediately, no cooldown): a rank was declared dead, or the
  pool is below target — run the full resize: shrink out the dead ranks,
  GROW replacements back to target, rebind the affected leases.
- **pressure grow** (hysteresis + cooldown): sustained queue pressure with
  headroom under ``TPU_MPI_ELASTIC_MAX_RANKS`` — raise the target by one
  and resize.
- **idle retire** (hysteresis + cooldown): a spare rank — healthy, leased
  by nobody, outside the infer engine — has been idle for
  ``TPU_MPI_ELASTIC_IDLE_TICKS`` ticks and the pool is above
  ``TPU_MPI_ELASTIC_MIN_RANKS`` — drain-and-retire it through the same
  shrink path a failure takes (deliberately: one code path, one set of
  invariants).

The resize itself is the two-phase rebind protocol (docs/fault-tolerance.md
"Elastic recovery"): pause the fair queue, drain in-flight ops, park the
infer scheduler at a step boundary, gate attaches; **quiesce** barrier over
the survivors; ``Comm_shrink`` + ``Comm_spawn``/``Intercomm_merge`` GROW;
remap dead->replacement in every affected lease (same cids — ledger books
and cid-range ownership survive untouched) and in the infer engine;
**resume** barrier over the full new pool; reopen the gates. Queued ops
never leave the fair queue during the window and in-flight ops are drained
before it opens, so no op is dropped or duplicated.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .. import config
from .. import locksmith
from ..analyze import events as _ev


class ElasticController:
    def __init__(self, broker, cfg=None):
        cfg = cfg or config.load()
        self.broker = broker
        self.interval = max(0.01, cfg.elastic_interval_ms / 1000.0)
        self.cooldown = max(0.0, cfg.elastic_cooldown_ms / 1000.0)
        self.hysteresis = max(1, int(cfg.elastic_hysteresis))
        self.depth_high = max(1, int(cfg.elastic_depth_high))
        self.idle_ticks_limit = max(0, int(cfg.elastic_idle_ticks))
        self.min_ranks = max(1, int(cfg.elastic_min_ranks))
        self.max_ranks = int(cfg.elastic_max_ranks) or broker.pool.nranks
        self.target = len(broker.pool.healthy())   # restore point
        self.drain_timeout = 10.0
        self._seq = 0
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._last_busy = 0
        self._last_resize_mono = 0.0
        self._resize_lock = locksmith.make_lock("elastic.resize")
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="elastic-controller",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def kick(self) -> None:
        """Wake the loop now (failure detector verdict just landed)."""
        self._kick.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.interval)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self._tick()
            except Exception as e:          # noqa: BLE001 - controller must live
                with self.broker._elastic_lock:
                    self.broker.elastic_state["last_error"] = repr(e)

    # -- decision loop -------------------------------------------------------
    def _tick(self) -> None:
        b = self.broker
        pool = b.pool
        # availability first: dead ranks (or a pool under target) restore
        # without hysteresis or cooldown — degraded minutes are SLO minutes
        if pool.failed - pool.retired or len(pool.healthy()) < self.target:
            self.resize("rank failure")
            return
        qs = b.fq.stats()
        depth = sum(t["queued"] for t in qs["tenants"].values())
        busy_delta = qs["rejected_busy"] - self._last_busy
        self._last_busy = qs["rejected_busy"]
        # ledger slack: bytes admitted but not yet measured on the pool — a
        # coarse how-far-behind signal that keeps working when queues are
        # bounded (rejections) rather than deep
        rep = b.ledger.report()
        admitted = sum(e["admitted_bytes"] for e in rep["tenants"].values())
        measured = sum(int((e.get("measured") or {}).get("bytes_sent", 0))
                       for e in rep["tenants"].values())
        slack = max(0, admitted - measured)
        slo_bad = False
        if b._infer_sched is not None:
            ss = b._infer_sched.stats()
            hr = ss.get("slo_hit_rate")
            fin = ss.get("slo_hits", 0) + ss.get("slo_misses", 0)
            slo_bad = hr is not None and fin >= 4 and hr < 0.9
        # latency-derived grow signal (docs/observability.md "SLO
        # burn-rate"): the worst tenant's measured miss fraction over its
        # error budget — above 1.0 the tenant is burning budget even if the
        # queue looks shallow (slow ranks, not deep queues)
        slo_burn = b.ledger.max_burn_rate()
        burn_bad = slo_burn is not None and slo_burn > 1.0
        pressured = (depth >= self.depth_high or busy_delta > 0 or slo_bad
                     or burn_bad)
        if pressured:
            self._pressure_ticks += 1
            self._idle_ticks = 0
        elif depth == 0 and busy_delta == 0:
            self._idle_ticks += 1
            self._pressure_ticks = 0
        else:
            self._pressure_ticks = 0
            self._idle_ticks = 0
        with b._elastic_lock:
            b.elastic_state["signals"] = {
                "depth": depth, "busy_delta": busy_delta,
                "ledger_slack_bytes": slack, "slo_bad": slo_bad,
                "slo_burn": slo_burn,
                "pressure_ticks": self._pressure_ticks,
                "idle_ticks": self._idle_ticks}
        if (self._last_resize_mono
                and time.monotonic() - self._last_resize_mono < self.cooldown):
            return
        cap = len(pool.healthy())
        if self._pressure_ticks >= self.hysteresis and cap < self.max_ranks:
            self.target = cap + 1
            self._pressure_ticks = 0
            self.resize("slo burn" if burn_bad and depth < self.depth_high
                        and busy_delta <= 0 else "queue pressure")
        elif (self.idle_ticks_limit
              and self._idle_ticks >= self.idle_ticks_limit
              and cap > self.min_ranks):
            spare = self._spare_rank()
            if spare is not None:
                self.target = cap - 1
                self._idle_ticks = 0
                pool.mark_failed(spare)     # drain-and-retire: failure path
                if b.sidecars is not None:
                    b.sidecars.retire(spare)
                self.resize("idle retire")

    def _spare_rank(self) -> Optional[int]:
        """A healthy rank no lease spans and the infer engine doesn't
        occupy — the only kind the idle path may retire."""
        b = self.broker
        used: set = set()
        with b._lease_lock:
            for lease in b._leases.values():
                used.update(lease.group)
        if b.infer_engine is not None:
            used.update(b.infer_engine.ranks)
        for r in reversed(b.pool.healthy()):
            if r not in used:
                return r
        return None

    # -- resize orchestration -------------------------------------------------
    def resize(self, reason: str) -> dict:
        """Run one full two-phase resize (see the module docstring for the
        protocol). Returns the ``last_resize`` record."""
        b = self.broker
        pool = b.pool
        with self._resize_lock:
            t0 = time.monotonic()
            self._seq += 1
            epoch = self._seq
            grew = shrunk = rebinds = 0
            b._resize_gate.clear()
            try:
                # ---- quiesce: stop dispatch, drain the pool -----------------
                b.fq.pause()
                deadline = time.monotonic() + self.drain_timeout
                while b.fq.inflight_total() and time.monotonic() < deadline:
                    time.sleep(0.005)
                if b._infer_sched is not None:
                    b._infer_sched.pause(timeout=30.0)
                dead: tuple = ()
                if pool.failed - pool.retired:
                    _, dead = pool.shrink_base()
                    shrunk = len(dead)
                self._round("quiesce", epoch)
                # ---- grow back to target ------------------------------------
                new_ranks: tuple = ()
                n_new = max(0, self.target - len(pool.healthy()))
                if n_new:
                    _, new_ranks = pool.grow_base(n_new)
                    grew = len(new_ranks)
                    if b.sidecars is not None:
                        for r in new_ranks:
                            b.sidecars.spawn_for(r)
                # ---- remap: dead -> replacement, same cids ------------------
                mapping = dict(zip(sorted(dead), new_ranks))
                if mapping:
                    rebinds = self._rebind_leases(mapping)
                    if b.infer_engine is not None and \
                            set(b.infer_engine.ranks) & mapping.keys():
                        b.infer_engine.rebind(mapping)
                self._round("resume", epoch)
            finally:
                if b._infer_sched is not None:
                    b._infer_sched.resume()
                b.fq.resume()
                b._resize_gate.set()
            self._last_resize_mono = time.monotonic()
            dur_ms = (self._last_resize_mono - t0) * 1e3
            record = {"reason": reason, "epoch": epoch,
                      "duration_ms": round(dur_ms, 3), "grew": grew,
                      "shrunk": shrunk, "rebinds": rebinds,
                      "at": time.time()}
            with b._elastic_lock:
                b.elastic_state["resizes"] += 1
                b.elastic_state["rebinds"] += rebinds
                b.elastic_state["last_resize"] = record
            from .. import perfvars
            if perfvars.enabled():
                perfvars.note_elastic(resizes=1, rebinds=rebinds, grown=grew,
                                      shrunk=shrunk)
                perfvars.set_elastic_gauges(
                    pool_size=len(pool.healthy()), target_size=self.target,
                    degraded=int(bool(pool.failed - pool.retired)))
            _ev.record_serve(pool.ctx, "resize", reason=reason, epoch=epoch,
                             grew=grew, shrunk=shrunk, rebinds=rebinds,
                             group=tuple(pool.base_comm.group))
            return record

    def _round(self, op: str, epoch: int) -> None:
        """One rebind round on every rank of the pool-wide comm (the ranks
        themselves rendezvous — a REAL Barrier, so explore models it and
        T214 audits the participant set). Delegated to the pool because the
        two backends reach their ranks differently: thread workers take a
        closure, procs workers take a framed 'round' op — the protocol
        (record + Barrier, elastic.protocol.rebind_round) is the same."""
        self.broker.pool.elastic_round(op, epoch)

    def _rebind_leases(self, mapping: dict) -> int:
        """Move every lease that spans a dead rank onto its replacement:
        position-wise group substitution, SAME cids (books and cid-range
        ownership survive), fresh channels via rebind_comm. A lease revoked
        while we iterate is skipped — revocation settled its state first."""
        b = self.broker
        n = 0
        with b._lease_lock:
            leases = list(b._leases.values())
        for lease in leases:
            if not set(lease.group) & mapping.keys():
                continue
            with b._lease_lock:
                if b._leases.get(lease.tenant) is not lease or lease.revoked:
                    continue            # revocation raced the rebind
                lease.group = tuple(mapping.get(r, r) for r in lease.group)
                group = lease.group
                cids = sorted(lease.comms, key=str)
            for cid in cids:
                b.pool.rebind_comm(cid, group, lease.tenant)
            b.ledger.note_rebind(lease.tenant)
            _ev.record_serve(b.pool.ctx, "lease_rebind", tenant=lease.tenant,
                             group=tuple(group),
                             mapping=sorted(map(list, mapping.items())))
            n += 1
        return n
