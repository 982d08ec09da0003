"""Pvar report CLI: ``python -m tpu_mpi_torch.stats`` / ``tpurun-torch --stats``.

Reads per-rank pvar dumps (``TPU_MPI_PVARS_DUMP`` output, one
``pvars-rank<R>.json`` per rank — see docs/observability.md) and prints
the cross-rank report: per-collective latency tables and log2-µs
histograms, bandwidth, host-path phase breakdown, P2P byte counters,
plan-cache hit rate, and the chunk-pipeline overlap fraction.

``tpurun-torch --stats <dir-or-files>`` reports existing dumps;
``tpurun-torch --stats -- <launch args...>`` runs a launch with dumping enabled
into a temp dir and reports it when the job exits (zero-setup profiling).

The serve tier's live export reuses this module (docs/observability.md
"Live export"): :func:`to_prometheus` flattens a broker STATS snapshot to
the Prometheus text exposition the ``METRICS`` frame serves, and
:func:`watch_fleet` drives ``tpurun-torch --serve --stats --watch`` — interval
deltas and rates over a polled broker fleet, tolerating unreachable
brokers mid-stream.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
import time as _time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

from . import perfvars
from . import tune

_BAR = 30    # histogram bar width (characters at the largest bucket)


def aggregate(records: Sequence[dict]) -> dict:
    """Cross-rank/comm merge of pvar dump records into one report object."""
    colls: Dict[Tuple[str, str, int], List[float]] = {}
    hist: Dict[str, List[int]] = {}
    phase = {p: 0.0 for p in perfvars.PHASES}
    rma = {"fence": 0, "lock": 0, "flush": 0}
    tot = {"bytes_sent": 0, "bytes_recv": 0, "sends": 0, "recvs": 0,
           "wait_s": 0.0}
    pipe = {"ops": 0, "chunks": 0, "fold_s": 0.0, "wait_after_first_s": 0.0}
    plan = {"hits": 0, "misses": 0, "evictions": 0}
    auto = {"tracked": 0, "armed": 0, "arms": 0, "demotions": 0, "hits": 0,
            "evictions": 0, "signatures": {}}
    infer: Dict[str, Any] = {"gauges": {}}
    train: Dict[str, Any] = {"gauges": {}, "step_ns_samples": []}
    elastic: Dict[str, Any] = {"gauges": {}}
    front: Dict[str, Any] = {"gauges": {}}
    batch = {"flushes": 0, "ops": 0}
    explore = {"calls": 0, "explored": 0, "table_swaps": 0,
               "last_swap_gen": 0}
    locks: Dict[str, Dict[str, int]] = {}
    arm_counts: Dict[Tuple[str, str], int] = {}
    nranks = set()
    for rec in records:
        pc = rec.get("plan_cache") or {}
        plan["hits"] += int(pc.get("hits", 0))
        plan["misses"] += int(pc.get("misses", 0))
        plan["evictions"] += int(pc.get("evictions", 0))
        au = pc.get("auto") or {}
        for k in ("tracked", "armed", "arms", "demotions", "hits",
                  "evictions"):
            auto[k] += int(au.get(k, 0))
        for k, v in (rec.get("infer") or {}).items():
            if k == "gauges":
                for g, gv in (v or {}).items():
                    infer["gauges"][g] = max(int(infer["gauges"].get(g, 0)),
                                             int(gv))
            else:
                infer[k] = int(infer.get(k, 0)) + int(v)
        for k, v in (rec.get("train") or {}).items():
            if k == "gauges":
                for g, gv in (v or {}).items():
                    train["gauges"][g] = max(int(train["gauges"].get(g, 0)),
                                             int(gv))
            elif k == "step_ns_samples":
                train["step_ns_samples"].extend(int(s) for s in (v or ()))
            else:
                train[k] = int(train.get(k, 0)) + int(v)
        for k, v in (rec.get("elastic") or {}).items():
            if k == "gauges":
                for g, gv in (v or {}).items():
                    elastic["gauges"][g] = max(
                        int(elastic["gauges"].get(g, 0)), int(gv))
            else:
                elastic[k] = int(elastic.get(k, 0)) + int(v)
        for k, v in (rec.get("front_door") or {}).items():
            if k == "gauges":
                for g, gv in (v or {}).items():
                    front["gauges"][g] = max(int(front["gauges"].get(g, 0)),
                                             int(gv))
            else:
                front[k] = int(front.get(k, 0)) + int(v)
        for name, row in (rec.get("locks") or {}).items():
            ent = locks.setdefault(name, {"acquires": 0, "contended": 0,
                                          "max_held_ns": 0})
            ent["acquires"] += int((row or {}).get("acquires", 0))
            ent["contended"] += int((row or {}).get("contended", 0))
            ent["max_held_ns"] = max(ent["max_held_ns"],
                                     int((row or {}).get("max_held_ns", 0)))
        for label, sig in (au.get("signatures") or {}).items():
            ent = auto["signatures"].setdefault(
                label, {"calls": 0, "hits": 0, "demotions": 0,
                        "armed": False})
            ent["calls"] += int(sig.get("calls", 0))
            ent["hits"] += int(sig.get("hits", 0))
            ent["demotions"] += int(sig.get("demotions", 0))
            ent["armed"] = ent["armed"] or bool(sig.get("armed"))
            ent["hit_rate"] = (round(ent["hits"] / ent["calls"], 4)
                               if ent["calls"] else None)
        # partial record (a broker that died mid-STATS leaves {address,
        # error}, or a truncated dump leaves comms: null) — skip, don't throw
        for comm in rec.get("comms") or ():
            nranks.add(int(comm.get("size") or 0))
            for k in ("bytes_sent", "bytes_recv", "sends", "recvs", "wait_s"):
                tot[k] += comm.get(k, 0)
            for p, s in (comm.get("phase_s") or {}).items():
                phase[p] = phase.get(p, 0.0) + s
            for k, v in (comm.get("rma") or {}).items():
                rma[k] = rma.get(k, 0) + v
            pl = comm.get("pipeline") or {}
            for k in pipe:
                pipe[k] += pl.get(k, 0)
            ba = comm.get("batch") or {}
            batch["flushes"] += int(ba.get("flushes") or 0)
            batch["ops"] += int(ba.get("ops") or 0)
            ex = comm.get("explore") or {}
            explore["calls"] += int(ex.get("calls") or 0)
            explore["explored"] += int(ex.get("explored") or 0)
            explore["table_swaps"] = max(explore["table_swaps"],
                                         int(ex.get("table_swaps") or 0))
            explore["last_swap_gen"] = max(explore["last_swap_gen"],
                                           int(ex.get("last_swap_gen") or 0))
            for t in comm.get("times", ()):
                key = (t["coll"], t["algo"], int(t["nbytes"]))
                if t["coll"] in tune.PORTFOLIO:
                    # arm view skips internal rendezvous (e.g. TuneSwap)
                    ak = (t["coll"], t["algo"])
                    arm_counts[ak] = arm_counts.get(ak, 0) + int(t["count"])
                ent = colls.setdefault(key, [0.0, 0.0, float("inf"), 0.0])
                ent[0] += t["count"]
                ent[1] += t["total_s"]
                ent[2] = min(ent[2], t["min_s"])
                ent[3] = max(ent[3], t["max_s"])
            for coll, buckets in (comm.get("hist") or {}).items():
                h = hist.setdefault(coll, [0] * len(buckets))
                if len(h) < len(buckets):
                    h.extend([0] * (len(buckets) - len(h)))
                for i, c in enumerate(buckets):
                    h[i] += c
    busy = pipe["fold_s"] + pipe["wait_after_first_s"]
    return {
        "nranks": sorted(n for n in nranks if n),
        "colls": colls, "hist": hist, "phase_s": phase, "rma": rma,
        "totals": tot, "plan_cache": plan, "auto_arm": auto,
        "batch": {**batch,
                  "occupancy": (round(batch["ops"] / batch["flushes"], 4)
                                if batch["flushes"] else None)},
        "pipeline": pipe,
        "overlap_fraction": (round(pipe["fold_s"] / busy, 4) if busy
                             else None),
        "explore": explore,
        "explore_fraction": (round(explore["explored"] / explore["calls"], 4)
                             if explore["calls"] else None),
        "arm_counts": arm_counts,
        "infer": infer,
        "train": train,
        "elastic": elastic,
        "front_door": front,
        "locks": locks,
    }


def _pctl(samples: Sequence[int], q: float) -> float:
    """Nearest-rank percentile of a sample list (q in [0, 1])."""
    s = sorted(samples)
    if not s:
        return 0.0
    return float(s[min(len(s) - 1, int(q * len(s)))])


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def render(agg: dict, out=None) -> None:
    """Print the human-readable report."""
    out = out or sys.stdout
    w = out.write
    w("== tpu_mpi pvar report ==\n")
    if agg["nranks"]:
        w(f"world sizes seen: {agg['nranks']}\n")

    colls = agg["colls"]
    if colls:
        w("\nper-collective latency (aggregated over ranks):\n")
        w(f"  {'collective':<12} {'algo':<10} {'payload':>9} {'count':>7} "
          f"{'mean':>10} {'min':>10} {'max':>10} {'algbw':>10}\n")
        for (coll, algo, nbytes), (cnt, tot_s, mn, mx) in sorted(colls.items()):
            mean = tot_s / cnt if cnt else 0.0
            bw = (f"{nbytes / mean / 1e9:.2f}GB/s"
                  if nbytes > 0 and mean > 0 else "-")
            w(f"  {coll:<12} {algo:<10} "
              f"{_fmt_bytes(nbytes) if nbytes >= 0 else '-':>9} "
              f"{int(cnt):>7} {mean * 1e6:>8.1f}us {mn * 1e6:>8.1f}us "
              f"{mx * 1e6:>8.1f}us {bw:>10}\n")

    for coll, buckets in sorted(agg["hist"].items()):
        total = sum(buckets)
        if not total:
            continue
        w(f"\nlatency histogram: {coll} ({total} ops, log2-us buckets)\n")
        peak = max(buckets)
        for i, c in enumerate(buckets):
            if not c:
                continue
            lo = 0 if i == 0 else 1 << (i - 1)
            hi = 1 << i
            bar = "#" * max(1, round(c / peak * _BAR))
            w(f"  [{lo:>8}, {hi:>8})us {c:>7} {bar}\n")

    phase = agg["phase_s"]
    if any(phase.values()):
        tot_p = sum(phase.values())
        w("\nhost-path phase breakdown (summed over ranks):\n")
        for p in perfvars.PHASES:
            s = phase.get(p, 0.0)
            w(f"  {p:<12} {s * 1e3:>9.2f}ms  {s / tot_p * 100 if tot_p else 0:>5.1f}%\n")

    t = agg["totals"]
    w(f"\np2p: {t['sends']} sends / {_fmt_bytes(t['bytes_sent'])} out, "
      f"{t['recvs']} recvs / {_fmt_bytes(t['bytes_recv'])} in, "
      f"{t['wait_s'] * 1e3:.2f}ms blocked in Wait\n")
    pc = agg["plan_cache"]
    lk = pc["hits"] + pc["misses"]
    if lk:
        w(f"plan cache: {pc['hits']}/{lk} hits "
          f"({pc['hits'] / lk * 100:.0f}%)"
          + (f", {pc['evictions']} evictions (TPU_MPI_PLAN_CACHE_MAX)"
             if pc.get("evictions") else "") + "\n")
    au = agg.get("auto_arm") or {}
    if au.get("arms") or au.get("tracked"):
        w(f"auto-arm: {au['armed']} armed / {au['tracked']} tracked "
          f"signatures, {au['arms']} arms, {au['demotions']} demotions, "
          f"{au['hits']} armed-path hits\n")
        for label, sig in sorted(au.get("signatures", {}).items()):
            hr = sig.get("hit_rate")
            w(f"  {label}: {sig['calls']} calls, {sig['hits']} hits"
              + (f" ({hr:.0%})" if hr is not None else "")
              + (", armed" if sig.get("armed") else "") + "\n")
    ba = agg.get("batch") or {}
    if ba.get("flushes"):
        w(f"batched submission: {ba['ops']} ops / {ba['flushes']} flushes "
          f"(occupancy {ba['occupancy']:.2f})\n")
    rma = agg["rma"]
    if any(rma.values()):
        w(f"rma epochs: {rma['fence']} fences, {rma['lock']} locks, "
          f"{rma['flush']} flushes\n")
    if agg["overlap_fraction"] is not None:
        p = agg["pipeline"]
        w(f"chunk pipeline: {int(p['ops'])} ops / {int(p['chunks'])} chunks, "
          f"overlap fraction {agg['overlap_fraction']:.3f} "
          f"(1.0 = transfers fully hidden behind folds)\n")
    ex = agg.get("explore") or {}
    if ex.get("calls"):
        w(f"\nonline tuning: {ex['calls']} decision-point calls, "
          f"{ex['explored']} explored "
          f"({agg['explore_fraction']:.1%}), "
          f"{ex['table_swaps']} table swaps"
          + (f" (last at config generation {ex['last_swap_gen']})"
             if ex["table_swaps"] else "") + "\n")
        w("  per-arm samples: " + "  ".join(
            f"{c}/{a}={n}" for (c, a), n in sorted(agg["arm_counts"].items()))
          + "\n")

    inf = agg.get("infer") or {}
    if inf.get("steps"):
        g = inf.get("gauges") or {}
        dec_s = inf.get("step_ns", 0) / 1e9
        tps = inf.get("tokens", 0) / dec_s if dec_s > 0 else 0.0
        mb = int(g.get("max_batch") or 0)
        occ = (inf.get("batch_slots", 0) / (inf["steps"] * mb)
               if mb else None)
        fin = inf.get("slo_hits", 0) + inf.get("slo_misses", 0)
        w(f"\ninference engine: {inf['steps']} steps, "
          f"{inf.get('tokens', 0)} tokens ({tps:.1f} tok/s), "
          f"{inf.get('prefills', 0)} prefills\n")
        if occ is not None:
            w(f"  batch occupancy {occ:.2f} of max_batch={mb}\n")
        if fin:
            w(f"  SLO: {inf.get('slo_hits', 0)}/{fin} hit "
              f"({inf.get('slo_hits', 0) / fin:.0%}), "
              f"{inf.get('slo_evictions', 0)} evictions\n")
        if g.get("kv_blocks_per_rank"):
            w(f"  KV pressure: peak {g.get('kv_peak_in_use_max', 0)}/"
              f"{g['kv_blocks_per_rank']} blocks/rank, "
              f"{g.get('kv_alloc_failures', 0)} alloc failures\n")
        pw, ser = inf.get("pwait_ns", 0), inf.get("stage_serial_ns", 0)
        if ser:
            w(f"  prefill stream: stage-1 waited {pw / 1e6:.2f}ms of the "
              f"{ser / 1e6:.2f}ms stage-0 produce time "
              f"({1 - pw / ser:.0%} overlapped)\n")
        rounds = inf.get("moe_rounds", 0)
        if rounds:
            toks = inf.get("tokens", 0)
            w(f"\ndecode: {rounds} collective layer rounds, "
              f"{rounds / toks:.2f} rounds/token\n" if toks else
              f"\ndecode: {rounds} collective layer rounds\n")
            drafted = inf.get("spec_drafted", 0)
            if drafted:
                acc = inf.get("spec_accepted", 0)
                w(f"  speculative: k={int(g.get('spec_k') or 1)}, "
                  f"{acc}/{drafted} extra drafts accepted "
                  f"({acc / drafted:.0%})\n")
        probed = (inf.get("kv_prefix_hit_tokens", 0)
                  + inf.get("kv_prefix_miss_tokens", 0))
        if probed or g.get("kv_prefix_entries_max") or g.get("kv_cow_forks"):
            w("\nkv cache:")
            if probed:
                hits = inf.get("kv_prefix_hit_tokens", 0)
                w(f" prefix {hits}/{probed} prompt tokens adopted "
                  f"({hits / probed:.0%} hit rate)")
            w("\n")
            w(f"  {g.get('kv_shared_blocks_max', 0)} shared blocks (peak), "
              f"{g.get('kv_prefix_entries_max', 0)} registry entries, "
              f"{g.get('kv_cow_forks', 0)} CoW forks\n")

    tr = agg.get("train") or {}
    if tr.get("steps"):
        g = tr.get("gauges") or {}
        samples = tr.get("step_ns_samples") or []
        p50 = _pctl(samples, 0.50) / 1e6
        p99 = _pctl(samples, 0.99) / 1e6
        window = tr.get("comm_window_ns", 0)
        waited = tr.get("wait_ns", 0)
        ofrac = (1.0 - waited / window) if window > 0 else None
        w(f"\ntraining: {tr['steps']} steps on world "
          f"{g.get('world', 0)}, step p50 {p50:.2f}ms / p99 {p99:.2f}ms\n")
        w(f"  gradient buckets: {g.get('nbuckets', 0)} x "
          f"{_fmt_bytes(g.get('bucket_bytes', 0))} cap, "
          f"{tr.get('bucket_flushes', 0)} flushes "
          f"({tr.get('starts', 0)} starts / {tr.get('waits', 0)} waits on "
          f"persistent handles)\n")
        if ofrac is not None:
            w(f"  overlap: {ofrac:.0%} of the {window / 1e6:.2f}ms comm "
              f"window hidden behind backward compute\n")
        if tr.get("reshards"):
            w(f"  reshard events: {tr['reshards']} "
              f"(checkpoint loads repartitioned across the world)\n")

    lw = agg.get("locks") or {}
    if lw:
        w("\nlock contention (TPU_MPI_LOCKCHECK witness):\n")
        w(f"  {'lock':<24} {'acquires':>9} {'contended':>10} "
          f"{'max held':>10}\n")
        for name, row in sorted(lw.items()):
            w(f"  {name:<24} {row['acquires']:>9} {row['contended']:>10} "
              f"{row['max_held_ns'] / 1e6:>8.2f}ms\n")

    fd = agg.get("front_door") or {}
    if fd.get("attaches") or (fd.get("gauges") or {}).get("open_sockets"):
        g = fd.get("gauges") or {}
        leases = fd.get("lease_hits", 0) + fd.get("lease_misses", 0)
        w(f"\nfront door (event transport): {fd.get('attaches', 0)} "
          f"attaches, {g.get('open_sockets', 0)} sockets open (peak), "
          f"{fd.get('wakeups', 0)} loop wakeups, "
          f"{fd.get('frames', 0)} frames\n")
        w(f"  worker pool: {g.get('workers_busy', 0)}/"
          f"{g.get('workers', 0)} busy (peak)\n")
        if leases:
            w(f"  recv leases: {fd.get('lease_hits', 0)}/{leases} pooled "
              f"({fd.get('lease_hits', 0) / leases:.0%} hit rate), "
              f"{fd.get('lease_drops', 0)} drops\n")

    ela = agg.get("elastic") or {}
    if ela.get("resizes") or ela.get("failures"):
        g = ela.get("gauges") or {}
        w(f"\nelastic capacity: {ela.get('resizes', 0)} resizes "
          f"({ela.get('grown', 0)} ranks grown, {ela.get('shrunk', 0)} "
          f"shrunk), {ela.get('failures', 0)} rank failures, "
          f"{ela.get('rebinds', 0)} lease rebinds\n")
        if g.get("pool_size"):
            w(f"  pool {g['pool_size']}/{g.get('target_size', '?')} ranks"
              + (" (DEGRADED)" if g.get("degraded") else "") + "\n")


# -- Prometheus text exposition (serve METRICS frame) -------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")
_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def _prom_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def to_prometheus(report: dict, prefix: str = "tpu_mpi") -> str:
    """Flatten a broker STATS snapshot (any nested dict of counters) to
    the Prometheus text exposition. Numeric leaves become
    ``<prefix>_<path_joined_by_underscores>``; entries under a ``tenants``
    dict become one series per tenant with a ``tenant`` label instead of a
    name component. Strings, lists and None are skipped — the exposition
    carries numbers, the JSON STATS frame carries everything."""
    lines: List[str] = []

    def emit(path: List[str], labels: Tuple[Tuple[str, str], ...],
             value: float) -> None:
        name = _NAME_OK.sub("_", "_".join([prefix] + path))
        lab = ("{" + ",".join(f'{k}="{_prom_label(v)}"' for k, v in labels)
               + "}") if labels else ""
        if isinstance(value, float) and not math.isfinite(value):
            return                        # NaN/inf: not a scrapeable sample
        lines.append(f"{name}{lab} {value}")

    def walk(path: List[str], val: Any,
             labels: Tuple[Tuple[str, str], ...]) -> None:
        if isinstance(val, bool):
            emit(path, labels, int(val))
        elif isinstance(val, (int, float)):
            emit(path, labels, val)
        elif isinstance(val, dict):
            if path and path[-1] == "tenants":
                for t in sorted(val):
                    walk(path[:-1] + ["tenant"], val[t],
                         labels + (("tenant", str(t)),))
            else:
                for k in sorted(val, key=str):
                    walk(path + [str(k)], val[k], labels)
        # strings / lists / None: intentionally not exported

    walk([], report, ())
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Parse a text exposition back into ``{series: value}`` (series =
    metric name plus its literal label block). Malformed lines raise
    ``ValueError`` — the CI round-trip gate wants loud, not lossy."""
    out: Dict[str, float] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        m = _LINE.match(ln)
        if m is None:
            raise ValueError(f"unparseable exposition line: {ln!r}")
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


# -- fleet watch (tpurun-torch --serve --stats --watch) -----------------------------

def _watch_counters(rep: dict) -> Dict[str, float]:
    q = rep.get("queue") or {}
    tot = rep.get("totals") or {}
    return {"dispatched": float(q.get("dispatched", 0) or 0),
            "rejected_busy": float(q.get("rejected_busy", 0) or 0),
            "bytes_sent": float(tot.get("bytes_sent", 0) or 0)}


def render_watch(records: Sequence[dict], prev: Dict[str, dict],
                 dt: float, out=None) -> None:
    """One watch frame: per broker, counter deltas/rates since the last
    poll; unreachable brokers render their ``{address, error}`` row and
    the stream keeps going (satellite: partial fleets stay watchable)."""
    out = out or sys.stdout
    w = out.write
    stamp = _time.strftime("%H:%M:%S")
    for rep in records:
        addr = str(rep.get("address"))
        if rep.get("error"):
            w(f"{stamp} {addr}: ERROR {rep['error']}\n")
            continue
        cur = _watch_counters(rep)
        base = prev.get(addr)
        if base is None:
            d = {k: 0.0 for k in cur}
        else:
            d = {k: cur[k] - base.get(k, 0.0) for k in cur}
        rate = (d["dispatched"] / dt) if dt > 0 else 0.0
        q = rep.get("queue") or {}
        depth = sum(int(t.get("queued", 0) or 0)
                    for t in (q.get("tenants") or {}).values())
        tenants = rep.get("tenants_attached") or []
        w(f"{stamp} {addr}  ops {int(cur['dispatched'])} "
          f"(+{int(d['dispatched'])}, {rate:.1f}/s)  "
          f"sent {_fmt_bytes(cur['bytes_sent'])} "
          f"(+{_fmt_bytes(max(0.0, d['bytes_sent']))})  "
          f"busy-rej +{int(d['rejected_busy'])}  depth {depth}  "
          f"tenants {len(tenants)}\n")
        for t, row in sorted(((rep.get("ledger") or {}).get("tenants")
                              or {}).items()):
            slo = (row or {}).get("slo")
            if not slo:
                continue
            w(f"         slo {t}: burn {slo['burn']:.2f} "
              f"(miss {slo['miss_frac']:.2%} of budget "
              f"{slo['budget']:.0%}, target {slo['target_us']}us, "
              f"{slo['ops']} ops)\n")


def watch_fleet(poll: Callable[[], List[dict]], interval: float = 2.0,
                iterations: Optional[int] = None, out=None,
                sleep: Callable[[float], None] = _time.sleep) -> int:
    """Poll ``poll()`` (a list of per-broker STATS records, each either a
    report or ``{"address", "error"}``) every ``interval`` seconds and
    stream delta frames until interrupted (or ``iterations`` polls, for
    tests). The loop survives any single broker going unreachable."""
    prev: Dict[str, Dict[str, float]] = {}
    last = _time.monotonic()
    n = 0
    while iterations is None or n < iterations:
        records = poll()
        now = _time.monotonic()
        render_watch(records, prev, dt=max(now - last, 1e-9), out=out)
        last = now
        prev = {str(r.get("address")): _watch_counters(r)
                for r in records if not r.get("error")}
        n += 1
        if iterations is not None and n >= iterations:
            break
        try:
            sleep(interval)
        except KeyboardInterrupt:
            break
    return 0


def _launch_and_collect(launch_args: List[str]) -> List[dict]:
    """Run a ``tpurun-torch`` launch with pvar dumping into a temp dir and load
    the per-rank dumps it leaves behind."""
    import os
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory(prefix="tpu_mpi_stats_") as td:
        env = dict(os.environ)
        env["TPU_MPI_PVARS"] = "1"
        env["TPU_MPI_PVARS_DUMP"] = td
        rc = subprocess.call([sys.executable, "-m", "tpu_mpi_torch.launcher",
                              *launch_args], env=env)
        if rc != 0:
            print(f"stats: launch exited {rc}", file=sys.stderr)
        recs = perfvars.load_dumps([td])
        if not recs:
            raise SystemExit(f"stats: the launch left no pvar dumps in {td}")
        return recs


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpurun-torch --stats",
        description="Aggregate per-rank pvar dumps into latency/bandwidth "
                    "tables (docs/observability.md).")
    p.add_argument("paths", nargs="*",
                   help="pvar dump files or directories (TPU_MPI_PVARS_DUMP "
                        "output); pass '-- <launch args>' to run a launch "
                        "with dumping enabled and report it")
    p.add_argument("--json", default=None,
                   help="also write the merged machine-readable record "
                        "('-' for stdout)")
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        cut = argv.index("--")
        argv, launch = argv[:cut], argv[cut + 1:]
    else:
        launch = None
    args = p.parse_args(argv)
    if launch:
        records = _launch_and_collect(launch)
    elif args.paths:
        records = perfvars.load_dumps(args.paths)
    else:
        p.error("give pvar dump paths, or '-- <launch args>' to run one")
    agg = aggregate(records)
    render(agg)
    if args.json:
        rec = {"schema": 1, "kind": "tpu_mpi_torch-stats",
               "sources": [r.get("_path", "?") for r in records],
               "colls": [{"coll": c, "algo": a, "nbytes": b, "count": v[0],
                          "total_s": v[1], "min_s": v[2], "max_s": v[3]}
                         for (c, a, b), v in sorted(agg["colls"].items())],
               "hist": agg["hist"], "phase_s": agg["phase_s"],
               "totals": agg["totals"], "rma": agg["rma"],
               "plan_cache": agg["plan_cache"], "auto_arm": agg["auto_arm"],
               "batch": agg["batch"], "pipeline": agg["pipeline"],
               "overlap_fraction": agg["overlap_fraction"],
               "explore": agg["explore"],
               "explore_fraction": agg["explore_fraction"],
               "infer": agg["infer"],
               "train": agg["train"],
               "elastic": agg["elastic"],
               "arm_counts": {f"{c}|{a}": n
                              for (c, a), n in sorted(
                                  agg["arm_counts"].items())},
               "nranks": agg["nranks"]}
        if args.json == "-":
            json.dump(rec, sys.stdout, indent=1)
            sys.stdout.write("\n")
        else:
            with open(args.json, "w") as f:
                json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
