"""Per-tenant accounting ledger + byte/op quota enforcement.

Two books per tenant (docs/serving.md "Accounting and quotas"):

- **admitted**: bytes/ops charged at admission time, BEFORE the collective
  runs. This is the authoritative book for quota enforcement — a quota
  breach rejects with the typed :class:`~tpu_mpi_torch.error.QuotaExceededError`
  and the op never touches the pool (reject, don't hang).
- **measured**: bytes/ops attributed from pvar snapshots
  (``tpu_mpi_torch.perfvars``) by cid-range ownership — every ``(rank, cid)``
  counter whose cid falls inside a tenant's leased namespace is that
  tenant's; counters on shared/pool cids land under the ``_pool``
  pseudo-tenant. By construction the per-tenant measured books sum to the
  pool totals, which tests/test_serve.py asserts.

``Pcontrol(level >= 2)`` from a session client — or a STATS request —
drives a flush of the measured book (the broker calls
:meth:`Ledger.flush_from_pvars` with a fresh snapshot).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from .. import error as _ec
from .. import locksmith
from ..error import MPIError, QuotaExceededError

POOL_TENANT = "_pool"     # pseudo-tenant for pre-lease / shared-cid traffic

# Tenant cid namespaces start above this floor (the thread tier's
# ``SpmdContext._ns_next_base``); shard bases are carved above it.
NS_FLOOR = 1 << 20


class CidShard:
    """One broker's disjoint slice of the tenant cid space.

    Multi-broker scale-out (docs/serving.md "Scale-out") gives broker
    ``index`` of ``count`` the half-open cid range
    ``[NS_FLOOR + index*span, NS_FLOOR + (index+1)*span)`` to carve tenant
    namespaces from — ranges of distinct shards are disjoint BY
    CONSTRUCTION (property-tested in tests/test_serve_scale.py), which is
    what lets the measured books of N brokers be summed without a cid ever
    landing in two tenants' rows (the cross-broker T208 invariant)."""

    SPAN = 1 << 24          # cids per broker: room for ~16k default leases

    def __init__(self, index: int = 0, count: int = 1,
                 span: Optional[int] = None):
        index, count = int(index), int(count)
        if count < 1 or not (0 <= index < count):
            raise MPIError(f"cid shard index {index}/{count} out of range",
                           code=_ec.ERR_ARG)
        self.index, self.count = index, count
        self.span = int(span or self.SPAN)
        self.base = NS_FLOOR + self.index * self.span
        self.limit = self.base + self.span

    @classmethod
    def parse(cls, spec: str) -> "CidShard":
        """``"index/count"`` (the TPU_MPI_SERVE_SHARD / --shard grammar);
        ""/None means the single-broker whole-range shard."""
        if not spec:
            return cls()
        idx, sep, cnt = str(spec).partition("/")
        try:
            if not sep:
                raise ValueError(spec)
            return cls(int(idx), int(cnt))
        except ValueError:
            raise MPIError(f"cid shard spec {spec!r} is not 'index/count'",
                           code=_ec.ERR_ARG) from None

    def owns(self, cid: Any) -> bool:
        return isinstance(cid, int) and self.base <= cid < self.limit

    def __repr__(self) -> str:
        return (f"CidShard({self.index}/{self.count}, "
                f"[{self.base}, {self.limit}))")


class Ledger:
    def __init__(self, quota_bytes: int = 0):
        self.quota_bytes = int(quota_bytes)
        self._lock = locksmith.make_lock("ledger")
        self._tenants: Dict[str, dict] = {}
        self._flushes = 0
        self._last_flush: Optional[float] = None
        # per-tenant latency objectives (docs/observability.md "SLO burn"):
        # {"target_us": ..., "budget": tolerated miss fraction}
        self._objectives: Dict[str, dict] = {}

    # -- SLO objectives (latency burn-rate) -----------------------------------
    def set_objective(self, tenant: str, target_us: int,
                      budget: float = 0.01) -> None:
        """Give ``tenant`` a latency objective: at most ``budget`` of its
        ops may take ``target_us`` or longer. The burn rate reported per
        flush is observed-miss-fraction / budget — above 1.0 the tenant is
        spending error budget faster than the objective allows, and the
        elastic controller treats it as grow pressure."""
        target_us, budget = int(target_us), float(budget)
        if target_us <= 0 or not 0.0 < budget <= 1.0:
            raise MPIError(
                f"SLO objective target_us={target_us} budget={budget} "
                f"invalid (need target_us > 0 and 0 < budget <= 1)",
                code=_ec.ERR_ARG)
        with self._lock:
            self._objectives[tenant] = {"target_us": target_us,
                                        "budget": budget}

    @staticmethod
    def _default_objective() -> Optional[dict]:
        """The fleet-wide objective TPU_MPI_SERVE_SLO_US applies to every
        tenant without an explicit one (0 = no objective)."""
        from .. import config as _cfg
        us = int(getattr(_cfg.load(), "serve_slo_us", 0))
        return {"target_us": us, "budget": 0.01} if us > 0 else None

    @staticmethod
    def _slo_row(hist, obj: dict) -> dict:
        """Fold one tenant's merged log2-µs latency histogram against its
        objective. Bucket ``i`` covers [2^(i-1), 2^i) µs (bucket 0 is
        [0, 1)); a bucket whose lower edge clears the target counts as
        missed in full — the conservative reading of a histogram."""
        total = sum(hist)
        miss = sum(c for i, c in enumerate(hist)
                   if (0 if i == 0 else 1 << (i - 1)) >= obj["target_us"])
        frac = (miss / total) if total else 0.0
        return {"target_us": obj["target_us"], "budget": obj["budget"],
                "ops": int(total), "misses": int(miss),
                "miss_frac": round(frac, 6),
                "burn": round(frac / obj["budget"], 4)}

    def max_burn_rate(self) -> Optional[float]:
        """The worst per-tenant SLO burn over the last measured flush —
        the elastic controller's latency-derived grow signal. None when no
        tenant has an objective (or none has measured latency yet)."""
        default = self._default_objective()
        worst: Optional[float] = None
        with self._lock:
            for t, e in self._tenants.items():
                obj = self._objectives.get(t) or default
                hist = e.get("lat_hist")
                if obj is None or not hist:
                    continue
                burn = self._slo_row(hist, obj)["burn"]
                if worst is None or burn > worst:
                    worst = burn
        return worst

    def _entry(self, tenant: str) -> dict:
        e = self._tenants.get(tenant)
        if e is None:
            e = self._tenants[tenant] = {
                "admitted_bytes": 0, "admitted_ops": 0,
                "rejected_quota": 0, "rejected_busy": 0,
                "rebinds": 0,
                "measured": {}, "attached_at": time.time(),
                "revoked": False, "detached": False,
            }
        return e

    # -- lease lifecycle -----------------------------------------------------
    def open_tenant(self, tenant: str) -> None:
        with self._lock:
            self._entry(tenant)

    def close_tenant(self, tenant: str, revoked: bool = False) -> None:
        """Keep the books (usage survives the lease for --stats); just mark
        how the lease ended."""
        with self._lock:
            e = self._tenants.get(tenant)
            if e is not None:
                e["revoked"] = revoked
                e["detached"] = True

    # -- admission book (quota authority) -------------------------------------
    def charge(self, tenant: str, nbytes: int, ops: int = 1) -> None:
        """Charge an op at admission; quota breach is a typed rejection and
        nothing is charged (the op will not run)."""
        with self._lock:
            e = self._entry(tenant)
            if self.quota_bytes and e["admitted_bytes"] + nbytes > self.quota_bytes:
                e["rejected_quota"] += 1
                raise QuotaExceededError(
                    f"tenant {tenant!r} quota exhausted: "
                    f"{e['admitted_bytes']} + {nbytes} > "
                    f"{self.quota_bytes} quota bytes "
                    f"(TPU_MPI_SERVE_QUOTA_BYTES)", tenant=tenant,
                    used=e["admitted_bytes"], quota=self.quota_bytes)
            e["admitted_bytes"] += int(nbytes)
            e["admitted_ops"] += int(ops)

    def note_busy(self, tenant: str) -> None:
        with self._lock:
            self._entry(tenant)["rejected_busy"] += 1

    def note_rebind(self, tenant: str) -> None:
        """An elastic resize moved this tenant's lease onto replacement
        ranks (tpu_mpi_torch.elastic): same cids, same books, new group. Counted
        so --stats can show how often a tenant rode through a resize."""
        with self._lock:
            self._entry(tenant)["rebinds"] += 1

    # -- measured book (pvar attribution) -------------------------------------
    def flush_from_pvars(self, snapshot: dict,
                         owner_of_cid: Callable[[Any], Optional[str]]) -> dict:
        """Rebuild the measured book from a pvar snapshot (the stable
        schema of ``perfvars.snapshot()``). ``owner_of_cid`` maps a cid to
        the owning tenant (None -> pool). Returns the pool-total row; the
        invariant ``sum(tenant rows) == pool totals`` holds by
        construction because every comm record lands in exactly one row."""
        books, hists, totals = self._attribute(snapshot, owner_of_cid)
        with self._lock:
            for t in self._tenants:
                self._tenants[t]["measured"] = books.pop(t, {})
                self._tenants[t]["lat_hist"] = hists.get(t) or []
            for t, row in books.items():
                e = self._entry(t)
                e["measured"] = row
                e["lat_hist"] = hists.get(t) or []
            self._flushes += 1
            self._last_flush = time.time()
        return totals

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        default_obj = self._default_objective()   # config read OUTSIDE the lock
        with self._lock:
            return self._report_locked(default_obj)

    def _report_locked(self, default_obj: Optional[dict] = None) -> dict:
        tenants = {}
        for t, e in self._tenants.items():
            row = {k: v for k, v in e.items()}
            obj = self._objectives.get(t) or default_obj
            hist = e.get("lat_hist")
            if obj is not None and hist:
                row["slo"] = self._slo_row(hist, obj)
            tenants[t] = row
        return {"quota_bytes": self.quota_bytes, "tenants": tenants,
                "flushes": self._flushes, "last_flush": self._last_flush}

    def flush_and_report(self, snapshot: dict,
                         owner_of_cid: Callable[[Any], Optional[str]]
                         ) -> tuple[dict, dict]:
        """Measured-book flush + report under ONE lock acquisition — the
        STATS fast path (a 1k-tenant fleet polling stats must not take the
        ledger lock three times per request).
        Returns ``(pool_totals, report)``."""
        books, hists, totals = self._attribute(snapshot, owner_of_cid)
        default_obj = self._default_objective()   # config read OUTSIDE the lock
        with self._lock:
            for t in self._tenants:
                self._tenants[t]["measured"] = books.pop(t, {})
                self._tenants[t]["lat_hist"] = hists.get(t) or []
            for t, row in books.items():
                e = self._entry(t)
                e["measured"] = row
                e["lat_hist"] = hists.get(t) or []
            self._flushes += 1
            self._last_flush = time.time()
            return totals, self._report_locked(default_obj)

    @staticmethod
    def _attribute(snapshot: dict,
                   owner_of_cid: Callable[[Any], Optional[str]]
                   ) -> tuple[Dict[str, dict], dict]:
        """Lock-free attribution pass shared by :meth:`flush_from_pvars`
        and :meth:`flush_and_report`: fold the snapshot's comm records into
        per-tenant measured rows + the pool-total row."""
        fields = ("bytes_sent", "bytes_recv", "sends", "recvs")
        totals = {f: 0 for f in fields}
        totals["coll_ops"] = 0
        books: Dict[str, dict] = {}
        hists: Dict[str, list] = {}
        for rec in snapshot.get("comms", ()):
            tenant = owner_of_cid(rec.get("cid")) or POOL_TENANT
            row = books.setdefault(tenant, {f: 0 for f in fields}
                                   | {"coll_ops": 0})
            for f in fields:
                v = int(rec.get(f, 0) or 0)
                row[f] += v
                totals[f] += v
            nops = sum(int(v) for v in (rec.get("ops") or {}).values())
            row["coll_ops"] += nops
            totals["coll_ops"] += nops
            # merged log2-µs latency histogram (all collectives of this
            # tenant's comms) — the SLO burn-rate input. Kept OUT of the
            # measured row: that book is scalar counters whose tenant rows
            # sum to the pool totals, and a list would break every
            # consumer that folds it.
            for buckets in (rec.get("hist") or {}).values():
                h = hists.setdefault(tenant, [])
                if len(h) < len(buckets):
                    h.extend([0] * (len(buckets) - len(h)))
                for i, c in enumerate(buckets):
                    h[i] += int(c)
        return books, hists, totals
