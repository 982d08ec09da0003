"""Collective algorithm portfolio + measurement-driven autotuner.

The reference outsources algorithm choice to libmpi's ``coll_tuned`` module
(``MPI.jl src/collective.jl:691-738``): MPICH/OpenMPI pick ring vs
recursive-doubling vs binomial per (collective, communicator size, message
size) from a *measured* decision table. This module is that layer for the
multi-process tier:

- :data:`PORTFOLIO` names every algorithm the proc-tier engine
  (``backend.ProcChannel``) implements per collective, and
  :func:`eligible` is the rank-uniform eligibility rule for each (the same
  deterministic-function-of-shared-values contract every tier gate obeys,
  so ranks can never pick different protocols for one round).
- :func:`select` is the ONE decision function — it replaces the scattered
  threshold constants. Resolution order: force-override
  (``TPU_MPI_COLL_ALGO`` / ``config.coll_algo``, for debugging and CI) →
  measured tuning table (``TPU_MPI_TUNE_TABLE`` / ``config.tune_table``,
  written by ``tpurun --tune``) → built-in heuristic. Every layer is
  clamped by :func:`eligible`, so a stale table or an aggressive override
  degrades to a correct algorithm instead of a protocol error.
  ``tpu_mpi_torch.collective`` calls it at plan-build time, so the chosen
  algorithm is cached inside the :class:`~tpu_mpi_torch.overlap.CollectivePlan`
  and invalidated with it (``config.GENERATION`` bumps on any reload,
  including a tuning-table change).
- :func:`autotune` / ``python -m tpu_mpi_torch.tune`` / ``tpurun --tune`` sweep
  algorithm × size ladder × nranks *on the actual substrate* (real child
  processes over the real transport), assert every algorithm's result is
  bitwise-equal to the star reference, and persist the measured crossovers
  as a TOML table :func:`select` loads.

The built-in heuristic intentionally reproduces the engine's historical
behavior (star below ``TPU_MPI_RING_MIN_BYTES``, ring above for commutative
ops, dissemination Barrier, binomial Bcast) plus the same-host shm fold for
the small-message band — theory-guided guesses. The measured table exists
precisely because such guesses are wrong per substrate: on a single-core
TCP-loopback box, message *count* dominates and log-P algorithms lose to
the star, while the shm fold (no transport hop at all) wins by an order of
magnitude; on a real multi-host network the table flips the other way.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import config

__all__ = ["PORTFOLIO", "eligible", "candidates", "select", "heuristic",
           "parse_override", "load_table", "load_db_table", "write_table",
           "topology_key", "autotune", "merge_db", "main"]


# Every algorithm the proc-tier engine implements, per collective. "star"
# is the generic root-serialized rendezvous (always eligible; the chunked
# "starc" pipeline is a transparent refinement of it, not a separate
# selection). The rest map to ProcChannel runners in tpu_mpi_torch/backend.py.
PORTFOLIO: Dict[str, Tuple[str, ...]] = {
    "allreduce":  ("star", "shm", "rdouble", "rabenseifner", "ring", "hier"),
    "barrier":    ("star", "shm", "dissemination"),
    "bcast":      ("star", "binomial"),
    "reduce":     ("star", "binomial"),
    "gather":     ("star", "binomial"),
    "scatter":    ("star", "binomial"),
    "allgather":  ("star", "ring", "hier"),
    "allgatherv": ("star", "ring"),
    "alltoall":   ("star", "pairwise", "hier"),
    "alltoallv":  ("star", "pairwise"),
}


def eligible(coll: str, algo: str, nranks: int, nbytes: Optional[int], *,
             commutative: bool = False, elementwise: bool = False,
             shm: bool = False, numeric: bool = True,
             domains: int = 0) -> bool:
    """Whether ``algo`` may run ``coll`` for this signature.

    Must stay a deterministic function of rank-uniform values: collective
    name, communicator size, payload bytes (uniform by the MPI count/dtype
    contract), op properties, config, and same-host topology (every rank of
    a single-host communicator agrees it is single-host). ``nbytes`` None
    means "payload size unknown" (object payloads) and disqualifies every
    size-gated algorithm. ``numeric`` means the payload is a fixed-dtype
    array (not dtype=object / arbitrary pickled objects). ``domains`` is
    the hierarchy-usable domain count from ``topology.domain_count`` (0 =
    flat world) — rank-uniform because the domain map is a function of
    the member list plus replicated inputs.
    """
    if algo == "star":
        return True
    if nranks < 2 or algo not in PORTFOLIO.get(coll, ()):
        return False
    if algo == "hier":
        # two-level composite: needs >= 2 contiguous equal domains with
        # >= 2 ranks each, raw array payloads of known size; the
        # allreduce variant chains per-segment rank-order left folds, so
        # it additionally needs an elementwise (segment-separable) op.
        if domains < 2 or nranks % domains or nranks // domains < 2:
            return False
        if not numeric or nbytes is None:
            return False
        return elementwise if coll == "allreduce" else True
    if algo == "shm":
        # the one-segment fold spans the whole communicator; a world split
        # into >= 2 domains (real hosts, or the TPU_MPI_DOMAINS emulation)
        # has no single shared segment — the comm layer's coll_shm_ok
        # already reports shm=False there, and this clamp keeps callers
        # that pass a stale flag (or probe eligibility off-comm) honest
        if not shm or domains >= 2:
            return False
        cap = config.load().coll_shm_max_bytes
        if cap <= 0:
            return False
        if coll == "barrier":
            return True
        # allreduce through the shm slots: fixed-size raw array payloads
        # folded flat at the owner — needs an elementwise op (flattening
        # must not change semantics) and a slot-sized payload.
        return (numeric and elementwise
                and nbytes is not None and nbytes < cap)
    if algo == "rdouble":
        # concatenation-allgather of raw contributions + the star's own
        # rank-order fold at every rank: any op, any picklable payload.
        return True
    if algo == "rabenseifner":
        # per-segment rank-order folds: elementwise (segment-separable),
        # raw array payloads only.
        return numeric and elementwise and nbytes is not None
    if algo == "ring":
        if coll == "allreduce":
            # ring order != rank order: commutativity required.
            return commutative and numeric and nbytes is not None
        return numeric                      # allgather / allgatherv
    if algo == "pairwise":
        return numeric                      # alltoall / alltoallv
    if algo in ("dissemination", "binomial"):
        return True
    return False


def candidates(coll: str, nranks: int, nbytes: Optional[int], *,
               commutative: bool = False, elementwise: bool = False,
               shm: bool = False, numeric: bool = True,
               domains: int = 0) -> List[str]:
    """Eligible algorithms for a signature, portfolio order."""
    return [a for a in PORTFOLIO.get(coll, ("star",))
            if eligible(coll, a, nranks, nbytes, commutative=commutative,
                        elementwise=elementwise, shm=shm, numeric=numeric,
                        domains=domains)]


# ---------------------------------------------------------------------------
# Force-override parsing ("allreduce=rdouble,barrier=star")
# ---------------------------------------------------------------------------

_override_cache: Tuple[str, Dict[str, str]] = ("", {})


def parse_override(spec: str) -> Dict[str, str]:
    """Parse ``config.coll_algo``: a comma list of ``collective=algorithm``
    pins. Unknown collectives/algorithms are ignored with a one-time
    warning rather than erroring — a typo'd debug knob must not take the
    job down."""
    global _override_cache
    if spec == _override_cache[0]:
        return _override_cache[1]
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        coll, _, algo = part.partition("=")
        coll, algo = coll.strip().lower(), algo.strip().lower()
        if coll in PORTFOLIO and algo in PORTFOLIO[coll]:
            out[coll] = algo
        else:
            print(f"tpu_mpi_torch: ignoring unknown algorithm override "
                  f"{part!r} (known: "
                  f"{ {c: list(a) for c, a in PORTFOLIO.items()} })",
                  file=sys.stderr)
    _override_cache = (spec, out)
    return out


# ---------------------------------------------------------------------------
# Tuning-table persistence (TOML): {(coll, nranks): [(min_bytes, algo)...]}
# ---------------------------------------------------------------------------

# Table shape on disk:
#
#   schema = 1
#   [allreduce.n8]
#   "0" = "shm"
#   "65536" = "ring"
#
# [<coll>.n<ranks>] sections map a byte threshold (TOML keys are strings)
# to the algorithm that wins from that size up. Thresholds are the measured
# crossover points, so at every measured (size, nranks) the table selects
# the argmin algorithm exactly.

# per-path (mtime, table) cache — a dict, not a single slot, because the
# table layer and the fleet database (config.tune_db) are consulted on the
# same select() call and a one-slot cache would thrash between them
_table_cache: Dict[str, Tuple[Any, Dict]] = {}
_TABLE_CACHE_CAP = 8
_table_warned: set = set()


def _parse_table_text(text: str) -> dict:
    """Tiny TOML-subset parser for the tuning table (sections + quoted
    string pairs), used when ``tomllib``/``tomli`` is unavailable
    (Python 3.10 without the vendored fallback's table support)."""
    root: dict = {}
    cur = root
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = root
            for part in line[1:-1].strip().split("."):
                part = part.strip().strip('"').strip("'")
                cur = cur.setdefault(part, {})
            continue
        key, eq, val = line.partition("=")
        if not eq:
            raise ValueError(f"tuning table line {ln}: not key = value")
        key = key.strip().strip('"').strip("'")
        val = val.split("#", 1)[0].strip()
        if val.startswith(("'", '"')):
            val = val[1:-1]
        elif val.isdigit():
            val = int(val)  # type: ignore[assignment]
        cur[key] = val
    return root


def _read_table_toml(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    try:
        import tomllib
        return tomllib.loads(data.decode())
    except ImportError:
        pass
    try:
        import tomli  # type: ignore
        return tomli.loads(data.decode())
    except ImportError:
        return _parse_table_text(data.decode())


def _ladders_from_raw(raw: dict) -> Dict[Tuple[str, int],
                                         List[Tuple[int, str]]]:
    """Crossover ladders from one parsed TOML tree level: every
    ``[<coll>.n<ranks>]`` section whose collective/algorithms the
    portfolio knows. Unknown sections (meta, provenance, samples, topo)
    fall through silently — forward compatibility."""
    table: Dict[Tuple[str, int], List[Tuple[int, str]]] = {}
    for coll, per_n in raw.items():
        if coll not in PORTFOLIO or not isinstance(per_n, dict):
            continue
        for nkey, ladder in per_n.items():
            if not (isinstance(ladder, dict) and nkey.startswith("n")):
                continue
            n = int(nkey[1:])
            ent = sorted(((int(th), str(algo))
                          for th, algo in ladder.items()
                          if str(algo) in PORTFOLIO[coll]),
                         reverse=True)
            if ent:
                table[(coll, n)] = ent
    return table


def _cached_table(cache_key: str, path: str, build) -> Dict:
    """mtime-cached table load with the shared unreadable/unusable
    warn-once behavior; ``build(raw)`` turns the parsed TOML into the
    table for this view."""
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        if path not in _table_warned:
            _table_warned.add(path)
            print(f"tpu_mpi_torch: tuning table {path!r} not readable; "
                  f"using the built-in heuristic", file=sys.stderr)
        return {}
    hit = _table_cache.get(cache_key)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        table = build(_read_table_toml(path))
    except Exception as e:
        if path not in _table_warned:
            _table_warned.add(path)
            print(f"tpu_mpi_torch: tuning table {path!r} unusable ({e}); "
                  f"using the built-in heuristic", file=sys.stderr)
        table = {}
    while len(_table_cache) >= _TABLE_CACHE_CAP:
        _table_cache.pop(next(iter(_table_cache)))
    _table_cache[cache_key] = (mtime, table)
    return table


def load_table(path: str) -> Dict[Tuple[str, int], List[Tuple[int, str]]]:
    """Load (and cache on mtime) a tuning table. A missing or malformed
    file disables the table layer with a one-time warning — the heuristic
    still serves, a bad table never takes the job down."""
    path = os.path.expanduser(path)
    return _cached_table(path, path, _ladders_from_raw)


def load_db_table(path: str, topology: str) -> Dict[Tuple[str, int],
                                                    List[Tuple[int, str]]]:
    """Per-topology view of a fleet database: the top-level ladders
    belong to the fabric named by ``[meta] topology`` (missing/empty
    meta = a plain v1 table, applied everywhere); every other fabric's
    ladders live under ``[topo."<key>".<coll>.n<n>]``. A query only ever
    sees its own topology's ladders, so ``_nearest_nranks``
    interpolation cannot leak a foreign fabric's crossovers."""
    path = os.path.expanduser(path)

    def build(raw: dict) -> Dict:
        meta = raw.get("meta")
        meta_topo = str(meta.get("topology", "") if isinstance(meta, dict)
                        else "")
        if not meta_topo or meta_topo == topology:
            return _ladders_from_raw(raw)
        topo = raw.get("topo")
        sub = topo.get(topology) if isinstance(topo, dict) else None
        return _ladders_from_raw(sub) if isinstance(sub, dict) else {}

    return _cached_table(f"{path}\x00{topology}", path, build)


def write_table(path: str,
                table: Dict[Tuple[str, int], List[Tuple[int, str]]],
                header: str = "") -> None:
    """Persist a tuning table as TOML (atomic rename)."""
    path = os.path.expanduser(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = ["# tpu_mpi_torch collective tuning table (tpurun --tune)"]
    if header:
        lines += [f"# {h}" for h in header.splitlines()]
    lines.append("schema = 1")
    for (coll, n) in sorted(table):
        lines.append(f"\n[{coll}.n{n}]")
        for th, algo in sorted(table[(coll, n)]):
            lines.append(f'"{th}" = "{algo}"')
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)


def _nearest_nranks(ns: Sequence[int], nranks: int) -> int:
    """The measured communicator size a query interpolates to: exact match,
    else the nearest measured size below (libmpi decision tables
    interpolate the same way), CLAMPED at the table edges — queries below
    the smallest measured size use the smallest, queries above the largest
    use the largest. No extrapolation: an n=3 query against a table
    measured at {4, 8} must not invent an unmeasured regime, and an n=16
    query against the same table pins to n=8."""
    if nranks in ns:
        return nranks
    below = [n for n in ns if n < nranks]
    return below[-1] if below else min(ns)


def _table_lookup(table: Dict[Tuple[str, int], List[Tuple[int, str]]],
                  coll: str, nranks: int,
                  nbytes: Optional[int]) -> Optional[str]:
    """The table's pick for one (coll, nranks, nbytes) query, via
    :func:`_nearest_nranks` interpolation over the measured sizes."""
    ns = sorted(n for (c, n) in table if c == coll)
    if not ns:
        return None
    n = _nearest_nranks(ns, nranks)
    size = 0 if nbytes is None else int(nbytes)
    # order-independent walk: loaded tables arrive descending-sorted, but
    # the in-memory table from _crossovers is built ascending
    for th, algo in sorted(table[(coll, n)], reverse=True):
        if size >= th:
            return algo
    return None


# ---------------------------------------------------------------------------
# Heuristic table + the one decision function
# ---------------------------------------------------------------------------

def heuristic(coll: str, nranks: int, nbytes: Optional[int], *,
              commutative: bool = False, elementwise: bool = False,
              shm: bool = False, numeric: bool = True,
              domains: int = 0) -> str:
    """Built-in crossovers (used when no measured table applies). The bulk
    threshold is ``backend._RING_MIN_BYTES`` — read live, because tests and
    users monkeypatch it / set ``TPU_MPI_RING_MIN_BYTES`` (the historical
    knob this table absorbed). Bulk algorithms take precedence over the shm
    fold so a forced-low ring threshold behaves exactly as it always has.
    On multi-domain worlds the two-level composite wins once the payload
    clears ``config.hier_min_bytes`` — inter-domain messages are the
    expensive resource there, and hierarchy sends D-1 of them per segment
    instead of n-1."""
    from . import backend as B

    def ok(algo: str) -> bool:
        return eligible(coll, algo, nranks, nbytes, commutative=commutative,
                        elementwise=elementwise, shm=shm, numeric=numeric,
                        domains=domains)

    ring_min = B._RING_MIN_BYTES
    bulky = numeric and nbytes is not None and nbytes >= ring_min
    hier_ok = (domains >= 2 and numeric and nbytes is not None
               and nbytes >= config.load().hier_min_bytes and ok("hier"))
    if coll == "allreduce":
        if hier_ok:
            return "hier"
        if bulky and ok("ring"):
            return "ring"
        if ok("shm"):
            return "shm"
        return "star"
    if coll == "barrier":
        return "shm" if ok("shm") else "dissemination"
    if coll == "bcast":
        return "binomial"
    if coll in ("allgather", "allgatherv"):
        if coll == "allgather" and hier_ok:
            return "hier"
        return "ring" if bulky and ok("ring") else "star"
    if coll == "alltoall":
        if hier_ok:
            return "hier"
        return "pairwise" if bulky and ok("pairwise") else "star"
    if coll == "alltoallv":
        # counts differ per rank: dtype-only gate (uniform by contract),
        # a size gate would let ranks disagree on the tier.
        return "pairwise" if ok("pairwise") else "star"
    return "star"           # reduce / gather / scatter default to the star


def topology_key(domains: int = 0, nranks: int = 0,
                 arch: Optional[str] = None) -> str:
    """Shared fleet-DB topology key — delegates to
    :func:`tpu_mpi_torch.topology.topology_key` so the runtime, sweeps and
    ``tune merge`` can never disagree on the spelling."""
    from . import topology as _topo
    return _topo.topology_key(domains, nranks, arch)


def select(coll: str, nranks: int, nbytes: Optional[int] = None, *,
           commutative: bool = False, elementwise: bool = False,
           shm: bool = False, numeric: bool = True,
           domains: int = 0) -> str:
    """THE algorithm decision for one collective signature.

    Resolution: force-override → online hot-swap table (the in-memory
    table the bandit loop recomputes from live arm stats,
    :mod:`tpu_mpi_torch.tune_online`) → measured table → fleet database
    (``config.tune_db``, written by ``tune merge``) → heuristic, each
    clamped by :func:`eligible`. Called once per plan signature (the
    result is cached inside the CollectivePlan); must stay deterministic
    across ranks for fixed rank-uniform inputs + uniform config — the
    online table satisfies this because every rank derives it from the
    SAME merged cross-rank stats in a lockstep swap round. The fleet DB
    layer resolves per-topology: only rows recorded under THIS world's
    ``topology_key`` are consulted, so a foreign fabric's crossovers are
    never applied here.
    """
    if nranks < 2:
        return "star"

    def ok(algo: str) -> bool:
        return eligible(coll, algo, nranks, nbytes, commutative=commutative,
                        elementwise=elementwise, shm=shm, numeric=numeric,
                        domains=domains)

    cfg = config.load()
    forced = parse_override(cfg.coll_algo).get(coll)
    if forced is not None and ok(forced):
        return forced
    if cfg.tune_explore > 0.0:
        from . import tune_online
        online = tune_online.table()
        if online:
            algo = _table_lookup(online, coll, nranks, nbytes)
            if algo is not None and ok(algo):
                return algo
    if cfg.tune_table:
        algo = _table_lookup(load_table(cfg.tune_table), coll, nranks, nbytes)
        if algo is not None and ok(algo):
            return algo
    if cfg.tune_db:
        algo = _table_lookup(
            load_db_table(cfg.tune_db, topology_key(domains, nranks)),
            coll, nranks, nbytes)
        if algo is not None and ok(algo):
            return algo
    return heuristic(coll, nranks, nbytes, commutative=commutative,
                     elementwise=elementwise, shm=shm, numeric=numeric,
                     domains=domains)


# ---------------------------------------------------------------------------
# The autotuner: measure every algorithm on the actual substrate
# ---------------------------------------------------------------------------

LADDER = (8, 64, 512, 4096, 32768, 262144, 2097152)
ROOTED_LADDER = (64, 4096, 262144)
SWEEP_COLLS = ("allreduce", "barrier", "bcast", "reduce", "gather", "scatter")


def _iters_for(nbytes: int, scale: float = 1.0) -> Tuple[int, int]:
    """(warmup, iters) per point; fewer repeats for bulk sizes."""
    if nbytes >= 1 << 20:
        w, it = 1, 3
    elif nbytes >= 1 << 18:
        w, it = 1, 5
    elif nbytes >= 1 << 15:
        w, it = 2, 10
    else:
        w, it = 3, 20
    return w, max(1, int(it * scale))


def _active_domains(nranks: int) -> int:
    """The hierarchy domain count ``TPU_MPI_DOMAINS`` implies for a world
    of ``nranks`` (0 when unset or the world doesn't split evenly) — the
    sweep-side mirror of ``topology.domain_count``, which needs a live
    communicator the tune CLI doesn't have."""
    k = int(config.load().domains)
    return k if (k >= 2 and nranks % k == 0 and nranks // k >= 2) else 0


def _sweep_spec(nranks: int, sizes: Sequence[int],
                colls: Sequence[str]) -> list:
    """The lockstep (coll, nbytes, algos) schedule for one world size.
    Algorithms are the deployment-eligible set per point (shm capped by the
    configured slot size etc., hier only on a multi-domain world), so the
    emitted table never selects something the runtime would clamp away."""
    points = []
    shm_ok = os.path.isdir("/dev/shm")   # single-host sweep by construction
    dom = _active_domains(nranks)
    for coll in colls:
        ladder: Sequence[int] = ((0,) if coll == "barrier"
                                 else sizes if coll == "allreduce"
                                 else [s for s in ROOTED_LADDER
                                       if s <= max(sizes)])
        for nbytes in ladder:
            algos = candidates(coll, nranks, nbytes, commutative=True,
                               elementwise=True, shm=shm_ok, numeric=True,
                               domains=dom)
            points.append((coll, int(nbytes), algos))
    return points


def _crossovers(rows: List[dict]) -> Dict[Tuple[str, int],
                                          List[Tuple[int, str]]]:
    """Reduce measured rows to threshold->algorithm crossover entries: at
    each measured size the winner is the argmin latency; thresholds sit at
    the measured sizes where the winner changes (so the table reproduces
    the argmin at every measured point exactly)."""
    best: Dict[Tuple[str, int], List[Tuple[int, str]]] = {}
    by_point: Dict[Tuple[str, int, int], Tuple[float, str]] = {}
    for r in rows:
        key = (r["coll"], r["nranks"], r["bytes"])
        if key not in by_point or r["lat_us"] < by_point[key][0]:
            by_point[key] = (r["lat_us"], r["algo"])
    for (coll, n, nbytes) in sorted(by_point):
        _, algo = by_point[(coll, n, nbytes)]
        ent = best.setdefault((coll, n), [])
        if not ent:
            ent.append((0, algo))            # below-ladder sizes inherit
        elif ent[-1][1] != algo:
            ent.append((nbytes, algo))
    return best


def rows_from_pvars(records: Sequence[dict],
                    min_samples: Optional[int] = None,
                    skipped: Optional[List[Tuple]] = None) -> List[dict]:
    """Measured rows (the autotune sweep's row schema) from pvar dump
    records (``perfvars.snapshot``): mean latency per (collective, world
    size, payload bytes, algorithm) aggregated across ranks and comms. The
    production workload's own counters become tuning input — the table is
    fed by the same measurements it will later be judged against.

    Cells with fewer than ``min_samples`` observations (default
    ``config.tune_min_samples``) are dropped — a single cold-start outlier
    must not set a crossover. Pass a list as ``skipped`` to collect the
    dropped (coll, nranks, nbytes, algo) keys."""
    if min_samples is None:
        min_samples = max(1, int(config.load().tune_min_samples))
    acc: Dict[Tuple[str, int, int, str], List[float]] = {}
    for rec in records:
        for comm in rec.get("comms", ()):
            n = int(comm.get("size") or 0)
            if n < 2:
                continue
            for t in comm.get("times", ()):
                # non-portfolio names (internal rendezvous like the online
                # tuner's own TuneSwap round) are not tunable cells
                if t["coll"] not in PORTFOLIO:
                    continue
                nbytes = int(t["nbytes"])
                key = (t["coll"], n, max(0, nbytes), t["algo"])
                ent = acc.setdefault(key, [0.0, 0.0])
                ent[0] += t["count"]
                ent[1] += t["total_s"]
    rows = []
    for (c, n, b, a), (cnt, tot) in sorted(acc.items()):
        if not cnt:
            continue
        if cnt < min_samples:
            if skipped is not None:
                skipped.append((c, n, b, a, int(cnt)))
            continue
        rows.append({"coll": c, "nranks": n, "bytes": b, "algo": a,
                     "count": int(cnt),
                     "lat_us": round(tot / cnt * 1e6, 3)})
    return rows


def table_from_pvars(paths: Sequence[str],
                     out_table: Optional[str] = None) -> dict:
    """Crossover table from pvar dumps: load, reduce to rows, argmin per
    measured point (``_crossovers``), optionally persist. A point measured
    under only ONE algorithm still pins that algorithm as its threshold
    entry — production counters rarely cover the full portfolio, so this
    table refines, not replaces, a sweep-built one."""
    from . import perfvars
    records = perfvars.load_dumps(paths)
    skipped: List[Tuple] = []
    rows = rows_from_pvars(records, skipped=skipped)
    table = _crossovers(rows)
    rec = {"bench": "coll_algos_from_pvars", "rows": rows,
           "table": {f"{c}.n{n}": {str(th): algo for th, algo in ent}
                     for (c, n), ent in table.items()},
           "min_samples": max(1, int(config.load().tune_min_samples)),
           "skipped_cells": len(skipped),
           "skipped": [{"coll": c, "nranks": n, "bytes": b, "algo": a,
                        "count": cnt} for c, n, b, a, cnt in skipped],
           "sources": [r["_path"] for r in records]}
    if out_table:
        write_table(out_table, table,
                    header=f"from pvar dumps: {len(records)} ranks")
        rec["table_path"] = os.path.expanduser(out_table)
    return rec


# ---------------------------------------------------------------------------
# Fleet database (schema 2): shared crossover ladders + the samples behind
# them
# ---------------------------------------------------------------------------

# DB shape on disk — a schema-1 table every existing consumer can load
# as-is (the ladder sections are byte-identical and load_table skips
# unknown top-level keys), plus the evidence behind the ladders:
#
#   schema = 2
#   [allreduce.n4]
#   "0" = "shm"
#   [meta]
#   topology = "single-host/x86_64"
#   [provenance.s0]
#   source = "pvars-rank0.json"
#   kind = "pvars"
#   [samples.allreduce.n4.shm]
#   "1024" = "32:41.5"              # observation count : mean latency (us)
#   [topo."2d4r/x86_64".allreduce.n8]
#   "0" = "hier"
#   [topo."2d4r/x86_64".samples.allreduce.n8.hier]
#   "65536" = "32:120.5"
#
# Keeping raw (count, mean) cells makes re-merges sample-count-weighted by
# construction: a node contributing 1000 observations of a cell outweighs
# one contributing 10, and folding the same DB again is idempotent on the
# ladders. The [meta] topology string is the database's DEFAULT fleet key:
# its ladders and samples sit at the top level (byte-compatible with the
# pre-topology schema), while every other fabric's rows live under
# [topo."<key>"...] — so one DB can hold the whole fleet's evidence and
# ``load_db_table`` serves each world only its own fabric's crossovers.


def _db_read(path: str) -> Tuple[Dict[Tuple[str, str, int, int, str],
                                      List[float]],
                                 List[dict], Dict]:
    """(samples, provenance, meta) from an existing fleet DB, for
    incremental re-merges; all-empty when the file is absent or predates
    schema 2 (plain tables contribute ladders via the overlay path, not
    samples). Sample keys are ``(topology, coll, nranks, bytes, algo)``;
    top-level sample sections belong to the DB's meta topology (``""``
    when the DB predates the field — the caller re-keys that to its
    default)."""
    samples: Dict[Tuple[str, str, int, int, str], List[float]] = {}
    prov: List[dict] = []
    meta: Dict = {}
    try:
        raw = _read_table_toml(os.path.expanduser(path))
    except Exception:
        return samples, prov, meta
    meta = dict(raw.get("meta") or {})
    pv = raw.get("provenance") or {}
    for skey in sorted(pv, key=str):
        if isinstance(pv[skey], dict):
            prov.append(dict(pv[skey]))

    def read_samples(tree: dict, topo: str) -> None:
        for coll, per_n in (tree.get("samples") or {}).items():
            if coll not in PORTFOLIO or not isinstance(per_n, dict):
                continue
            for nkey, per_algo in per_n.items():
                if not (isinstance(per_algo, dict)
                        and str(nkey).startswith("n")):
                    continue
                n = int(str(nkey)[1:])
                for algo, cells in per_algo.items():
                    if (algo not in PORTFOLIO[coll]
                            or not isinstance(cells, dict)):
                        continue
                    for bkey, val in cells.items():
                        cnt_s, _, mean_s = str(val).partition(":")
                        try:
                            cnt, mean = int(cnt_s), float(mean_s)
                        except ValueError:
                            continue
                        ent = samples.setdefault(
                            (topo, coll, n, int(bkey), algo), [0, 0.0])
                        ent[0] += cnt
                        ent[1] += cnt * mean

    read_samples(raw, str(meta.get("topology") or ""))
    topo_tree = raw.get("topo")
    if isinstance(topo_tree, dict):
        for tkey, sub in topo_tree.items():
            if isinstance(sub, dict):
                read_samples(sub, str(tkey))
    return samples, prov, meta


def _write_db(path: str,
              samples: Dict[Tuple[str, str, int, int, str], List[float]],
              overlay: Dict[Tuple[str, int], List[Tuple[int, str]]],
              provenance: List[dict], meta: Dict,
              min_samples: int) -> dict:
    """Derive per-topology ladders from the merged samples (min-samples
    guard applied per cell), overlay sample-less measured-table ladders
    for default-topology (coll, nranks) keys the samples don't cover, and
    persist the schema-2 DB atomically. The meta topology's ladders and
    samples keep the legacy top-level layout; every other topology's go
    under ``[topo."<key>"...]``. Returns the merge record."""
    default_topo = str(meta.get("topology") or "")
    rows: List[dict] = []
    skipped: List[Tuple] = []
    by_topo_rows: Dict[str, List[dict]] = {}
    for (topo, c, n, b, a), (cnt, tot_us) in sorted(samples.items()):
        if cnt < min_samples:
            skipped.append((c, n, b, a, int(cnt)))
            continue
        row = {"topology": topo, "coll": c, "nranks": n, "bytes": b,
               "algo": a, "count": int(cnt),
               "lat_us": round(tot_us / cnt, 3)}
        rows.append(row)
        by_topo_rows.setdefault(topo, []).append(row)

    tables: Dict[str, Dict[Tuple[str, int], List[Tuple[int, str]]]] = {
        topo: _crossovers(trows) for topo, trows in by_topo_rows.items()}
    table = tables.setdefault(default_topo, {})
    overlaid = []
    for k, ent in sorted(overlay.items()):
        if k not in table:
            table[k] = list(ent)
            overlaid.append(f"{k[0]}.n{k[1]}")

    path = os.path.expanduser(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = ["# tpu_mpi_torch fleet tuning database (python -m tpu_mpi_torch.tune merge)",
             "schema = 2"]

    def emit_ladders(tab: Dict, prefix: str) -> None:
        for (coll, n) in sorted(tab):
            lines.append(f"\n[{prefix}{coll}.n{n}]")
            for th, algo in sorted(tab[(coll, n)]):
                lines.append(f'"{th}" = "{algo}"')

    def emit_samples(topo: str, prefix: str) -> None:
        by_sec: Dict[Tuple[str, int, str],
                     List[Tuple[int, int, float]]] = {}
        for (t, c, n, b, a), (cnt, tot_us) in samples.items():
            if t == topo:
                by_sec.setdefault((c, n, a), []).append(
                    (b, int(cnt), tot_us / cnt))
        for (c, n, a) in sorted(by_sec):
            lines.append(f"\n[{prefix}samples.{c}.n{n}.{a}]")
            for b, cnt, mean in sorted(by_sec[(c, n, a)]):
                lines.append(f'"{b}" = "{cnt}:{round(mean, 3)}"')

    emit_ladders(table, "")
    lines.append("\n[meta]")
    for k in sorted(meta):
        v = meta[k]
        lines.append(f"{k} = {v}" if isinstance(v, int)
                     else f'{k} = "{v}"')
    for i, ent in enumerate(provenance):
        lines.append(f"\n[provenance.s{i}]")
        for k in sorted(ent):
            v = ent[k]
            lines.append(f"{k} = {v}" if isinstance(v, int)
                         else f'{k} = "{v}"')
    emit_samples(default_topo, "")
    for topo in sorted(tables):
        if topo == default_topo:
            continue
        emit_ladders(tables[topo], f'topo."{topo}".')
        emit_samples(topo, f'topo."{topo}".')
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)

    all_topos = sorted({t for (t, *_rest) in samples} | {default_topo})
    return {"bench": "tune_merge", "db_path": path,
            "schema": 2, "meta": dict(meta),
            "min_samples": min_samples,
            "cells": len(samples), "rows": rows,
            "skipped_cells": len(skipped),
            "skipped": [{"coll": c, "nranks": n, "bytes": b, "algo": a,
                         "count": cnt} for c, n, b, a, cnt in skipped],
            "overlaid": overlaid,
            "topologies": all_topos,
            "table": {f"{c}.n{n}": {str(th): algo for th, algo in ent}
                      for (c, n), ent in table.items()},
            "tables": {topo: {f"{c}.n{n}": {str(th): algo
                                            for th, algo in ent}
                              for (c, n), ent in tab.items()}
                       for topo, tab in tables.items()},
            "provenance": provenance}


def merge_db(out_path: str, pvar_paths: Sequence[str] = (),
             table_paths: Sequence[str] = (),
             min_samples: Optional[int] = None,
             topology: Optional[str] = None) -> dict:
    """Fold per-rank pvar dumps and measured tuning tables into one shared
    fleet database at ``out_path`` (``select()`` loads it through
    ``config.tune_db`` with the same nearest-nranks interpolation as the
    per-job table). An existing DB at the path is folded back in first, so
    repeated merges accumulate fleet evidence instead of overwriting it;
    measured v1 tables carry no samples and contribute their ladders only
    where the samples are silent."""
    from . import perfvars
    if min_samples is None:
        min_samples = max(1, int(config.load().tune_min_samples))
    out_path = os.path.expanduser(out_path)
    samples, prov, meta = (_db_read(out_path) if os.path.exists(out_path)
                           else ({}, [], {}))
    if topology is not None:
        meta["topology"] = topology
    elif not meta.get("topology"):
        # the shared key helper — the same spelling the runtime stamps
        # into pvar dump records, so merge and runtime can never disagree
        meta["topology"] = topology_key()
    meta["merged_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    default_topo = str(meta["topology"])
    # pre-topology DBs carry "" sample keys: they are the DB's own rows
    for key in [k for k in samples if k[0] == ""]:
        ent = samples.setdefault((default_topo,) + key[1:], [0, 0.0])
        old = samples.pop(key)
        ent[0] += old[0]
        ent[1] += old[1]

    records = perfvars.load_dumps(pvar_paths) if pvar_paths else []
    for rec in records:
        # dump records are stamped with the topology key of the world
        # that produced them (perfvars.snapshot); unstamped legacy dumps
        # fold into the DB's default fabric
        rtopo = str(rec.get("topology") or "") or default_topo
        ncomms = 0
        for comm in rec.get("comms", ()):
            n = int(comm.get("size") or 0)
            if n < 2:
                continue
            ncomms += 1
            for t in comm.get("times", ()):
                coll, algo = t["coll"], t["algo"]
                if coll not in PORTFOLIO or algo not in PORTFOLIO[coll]:
                    continue
                key = (rtopo, coll, n, max(0, int(t["nbytes"])), algo)
                ent = samples.setdefault(key, [0, 0.0])
                ent[0] += int(t["count"])
                ent[1] += float(t["total_s"]) * 1e6
        prov.append({"source": os.path.basename(rec["_path"]),
                     "kind": "pvars", "comms": ncomms, "topology": rtopo})
    overlay: Dict[Tuple[str, int], List[Tuple[int, str]]] = {}
    for tp in table_paths:
        t = load_table(tp)
        for k, ent in t.items():
            overlay.setdefault(k, list(ent))
        prov.append({"source": os.path.basename(os.path.expanduser(tp)),
                     "kind": "table", "entries": len(t)})
    return _write_db(out_path, samples, overlay, prov, meta, min_samples)


def merge_main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m tpu_mpi_torch.tune merge`` / ``tpurun --tune merge``."""
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m tpu_mpi_torch.tune merge",
        description="Fold per-rank pvar dumps and measured tuning tables "
                    "into one shared fleet database (schema 2, "
                    "sample-count-weighted), loaded by select() via "
                    "TPU_MPI_TUNE_DB.")
    p.add_argument("sources", nargs="*", metavar="PVAR_DUMP",
                   help="pvar dump files/dirs (TPU_MPI_PVARS_DUMP output)")
    p.add_argument("--table", action="append", default=[], metavar="TOML",
                   help="measured tuning table to fold in (ladder overlay "
                        "for (coll, nranks) keys without samples); repeat "
                        "for several")
    p.add_argument("-o", "--out", default=None,
                   help="fleet DB path (default: $TPU_MPI_TUNE_DB or "
                        "~/.config/tpu_mpi/tune-db.toml)")
    p.add_argument("--min-samples", type=int, default=None,
                   help="noise guard: drop cells with fewer observations "
                        "(default $TPU_MPI_TUNE_MIN_SAMPLES)")
    p.add_argument("--topology", default=None,
                   help="fleet key stamped into [meta] (default: keep the "
                        "existing DB's, else single-host/<machine>)")
    p.add_argument("--json", default=None,
                   help="also write the merge record as JSON")
    args = p.parse_args(argv)
    if not args.sources and not args.table:
        p.error("nothing to merge: give pvar dumps and/or --table files")
    out = (args.out or config.load().tune_db
           or os.path.join("~", ".config", "tpu_mpi", "tune-db.toml"))
    rec = merge_db(out, args.sources, args.table,
                   min_samples=args.min_samples, topology=args.topology)
    if args.json:
        with open(os.path.expanduser(args.json), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"tune merge: {rec['db_path']} <- {len(rec['provenance'])} "
          f"sources, {rec['cells']} sample cells "
          f"({rec['skipped_cells']} below min_samples="
          f"{rec['min_samples']}), topology {rec['meta']['topology']}")
    for sect, ladder in sorted(rec["table"].items()):
        tag = " (overlay)" if sect in rec["overlaid"] else ""
        print(f"  [{sect}]{tag} " + "  ".join(
            f"{th}B->{algo}" for th, algo in sorted(
                ladder.items(), key=lambda kv: int(kv[0]))))
    return 0


# ---------------------------------------------------------------------------
# Regression sentinel: does the committed table still win here?
# ---------------------------------------------------------------------------

def sentinel_main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m tpu_mpi_torch.tune sentinel`` — re-measure the committed
    tuning artifacts' points on the current runner (best-of-N repeats to
    suppress scheduler noise) and fail when the committed table's selection
    loses to an eligible alternate by more than the threshold, printing the
    offending cells. CI runs this against the committed cpusim artifacts so
    a substrate drift that invalidates them fails loudly instead of
    silently serving a stale table."""
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m tpu_mpi_torch.tune sentinel",
        description="Replay the committed tuning artifacts and fail when a "
                    "committed selection loses to an eligible alternate on "
                    "this runner.")
    p.add_argument("--table", default="benchmarks/results/tune-cpusim.toml",
                   help="committed tuning table to judge")
    p.add_argument("--record", default="benchmarks/results/"
                                       "coll-algos-cpusim.json",
                   help="committed sweep record naming the measured points")
    p.add_argument("--threshold", type=float, default=1.10,
                   help="fail ratio, committed selection vs best measured "
                        "(default 1.10 = loses by >10%%)")
    p.add_argument("--repeat", type=int, default=3,
                   help="best-of-N sweep repeats per world size (noise "
                        "suppression; default 3)")
    p.add_argument("--nranks", default=None,
                   help="restrict to these world sizes (comma list; "
                        "default: every size in the record)")
    p.add_argument("--max-points", type=int, default=0,
                   help="cap (coll, size) points per world size (0 = all)")
    p.add_argument("--scale", type=float, default=0.5,
                   help="iteration-count multiplier per point (default 0.5)")
    p.add_argument("--json", default=None,
                   help="also write the sentinel record as JSON")
    args = p.parse_args(argv)

    committed = load_table(args.table)
    if not committed:
        print(f"tune sentinel: no committed table at {args.table!r}",
              file=sys.stderr)
        return 2
    with open(os.path.expanduser(args.record)) as f:
        rec = json.load(f)
    want_n = ([int(x) for x in args.nranks.split(",") if x]
              if args.nranks else None)
    pts: Dict[int, Dict[Tuple[str, int], List[str]]] = {}
    for r in rec.get("rows", []):
        n = int(r["nranks"])
        if (want_n and n not in want_n) or r["coll"] not in SWEEP_COLLS:
            continue
        # topology-keyed records: a row measured on a foreign fabric (a
        # different domain shape than this runner reproduces) is not
        # replayable here and must not be judged here
        rtopo = r.get("topology")
        if rtopo and rtopo != topology_key(_active_domains(n), n):
            continue
        algos = pts.setdefault(n, {}).setdefault(
            (r["coll"], int(r["bytes"])), [])
        if r["algo"] not in algos:
            algos.append(r["algo"])
    if not pts:
        print("tune sentinel: record names no replayable points",
              file=sys.stderr)
        return 2

    best_lat: Dict[Tuple[str, int, int, str], float] = {}
    for n, cells in sorted(pts.items()):
        points = [[coll, b, algos]
                  for (coll, b), algos in sorted(cells.items())]
        if args.max_points:
            points = points[:args.max_points]
        for rep in range(max(1, args.repeat)):
            print(f"tune sentinel: n{n} pass {rep + 1}/{args.repeat} "
                  f"({len(points)} points) ...", file=sys.stderr)
            for r in _run_sweep(n, points, args.scale):
                k = (r["coll"], int(r["nranks"]), int(r["bytes"]), r["algo"])
                lat = float(r["lat_us"])
                if k not in best_lat or lat < best_lat[k]:
                    best_lat[k] = lat

    by_point: Dict[Tuple[str, int, int], Dict[str, float]] = {}
    for (coll, n, b, a), lat in best_lat.items():
        by_point.setdefault((coll, n, b), {})[a] = lat
    offending, checked = [], 0
    for (coll, n, b), algs in sorted(by_point.items()):
        picked = _table_lookup(committed, coll, n, b)
        if picked is None or picked not in algs:
            continue            # heuristic-governed or unmeasurable here
        checked += 1
        best_algo = min(algs, key=algs.get)
        ratio = algs[picked] / max(algs[best_algo], 1e-9)
        if ratio > args.threshold:
            offending.append({"coll": coll, "nranks": n, "bytes": b,
                              "committed": picked,
                              "committed_lat_us": round(algs[picked], 2),
                              "best": best_algo,
                              "best_lat_us": round(algs[best_algo], 2),
                              "ratio": round(ratio, 3)})
    out_rec = {"bench": "tune_sentinel", "table": args.table,
               "record": args.record, "threshold": args.threshold,
               "repeat": args.repeat, "checked_cells": checked,
               "offending": offending}
    if args.json:
        with open(os.path.expanduser(args.json), "w") as f:
            json.dump(out_rec, f, indent=1)
    if offending:
        print(f"tune sentinel: FAIL — {len(offending)}/{checked} committed "
              f"selections lose by >{(args.threshold - 1) * 100:.0f}% on "
              f"this runner:")
        for c in offending:
            print(f"  {c['coll']:<10} n{c['nranks']} {c['bytes']:>9d}B "
                  f"committed {c['committed']:<13} "
                  f"{c['committed_lat_us']:>10.1f}us vs best {c['best']} "
                  f"{c['best_lat_us']:.1f}us (x{c['ratio']})")
        print("  -> re-run `python -m tpu_mpi_torch.tune` on this runner and "
              "commit the refreshed artifacts")
        return 1
    print(f"tune sentinel: OK — {checked} committed selections hold within "
          f"{(args.threshold - 1) * 100:.0f}% on this runner")
    return 0


# ---------------------------------------------------------------------------
# Online-exploration report (tpurun --tune --online)
# ---------------------------------------------------------------------------

def _online_report(paths: Sequence[str], json_out: Optional[str] = None,
                   ) -> int:
    """What the in-process bandit did, reconstructed from pvar dumps:
    explored-call fraction through the decision point, per-arm sample
    counts, table swaps and the last swap's config generation, plus the
    crossover table the accumulated arms imply (what the next lockstep
    swap would install)."""
    from . import perfvars
    records = perfvars.load_dumps(paths)
    calls = explored = swaps = 0
    last_gen = 0
    for rec in records:
        for comm in rec.get("comms", ()):
            ex = comm.get("explore") or {}
            calls += int(ex.get("calls") or 0)
            explored += int(ex.get("explored") or 0)
            swaps = max(swaps, int(ex.get("table_swaps") or 0))
            last_gen = max(last_gen, int(ex.get("last_swap_gen") or 0))
    rows = rows_from_pvars(records, min_samples=1)
    implied = _crossovers(rows_from_pvars(records))
    rec_out = {"bench": "tune_online_report", "ranks": len(records),
               "explore": {"calls": calls, "explored": explored,
                           "fraction": (round(explored / calls, 4)
                                        if calls else None),
                           "table_swaps": swaps, "last_swap_gen": last_gen},
               "arms": rows,
               "implied_table": {
                   f"{c}.n{n}": {str(th): algo for th, algo in ent}
                   for (c, n), ent in implied.items()}}
    if json_out:
        with open(os.path.expanduser(json_out), "w") as f:
            json.dump(rec_out, f, indent=1)
    frac = f"{explored / calls:.1%}" if calls else "n/a"
    print(f"online: {len(records)} ranks, {calls} decision-point calls, "
          f"{explored} explored ({frac}), {swaps} table swaps "
          f"(last at config generation {last_gen})")
    if rows:
        print("arms (count-weighted mean latency):")
        for r in rows:
            print(f"  {r['coll']:<10} n{r['nranks']} {r['bytes']:>9d}B "
                  f"{r['algo']:<13} count={r['count']:<6d} "
                  f"{r['lat_us']:>10.1f} us")
    if implied:
        print("implied table (what the next lockstep swap would install):")
        for (c, n), ent in sorted(implied.items()):
            print(f"  [{c}.n{n}] " + "  ".join(
                f"{th}B->{algo}" for th, algo in sorted(ent)))
    return 0


def _run_sweep(nranks: int, points: list, scale: float) -> List[dict]:
    """Run the lockstep bench over ``points`` on ``nranks`` child
    processes. The sweep launches real processes through the multi-process
    tier, which is not ported yet (ROADMAP Queue A item 9)."""
    raise NotImplementedError(
        "tune sweeps need the multi-process tier, not ported yet "
        "(ROADMAP Queue A item 9)")


def autotune(nranks_list: Sequence[int] = (2, 4, 8),
             sizes: Sequence[int] = LADDER,
             colls: Sequence[str] = SWEEP_COLLS,
             scale: float = 1.0,
             out_table: Optional[str] = None,
             out_json: Optional[str] = None,
             verbose: bool = True) -> dict:
    """Run the sweep, write the tuning table, return the full record."""
    t_start = time.time()
    rows: List[dict] = []
    for n in nranks_list:
        points = _sweep_spec(n, sizes, colls)
        if verbose:
            npts = sum(len(p[2]) for p in points)
            print(f"tune: sweeping {npts} (coll, size, algo) points "
                  f"on {n} ranks ...", file=sys.stderr)
        tkey = topology_key(_active_domains(n), n)
        for r in _run_sweep(n, points, scale):
            r.setdefault("topology", tkey)
            rows.append(r)

    table = _crossovers(rows)
    # selection audit: what the freshly-written table picks at every
    # measured point, vs the best measured algorithm there
    by_point: Dict[Tuple[str, int, int], List[dict]] = {}
    for r in rows:
        by_point.setdefault((r["coll"], r["nranks"], r["bytes"]), []).append(r)
    selection = []
    for (coll, n, nbytes), prs in sorted(by_point.items()):
        best = min(prs, key=lambda r: r["lat_us"])
        picked = _table_lookup(table, coll, n, nbytes) or heuristic(
            coll, n, nbytes, commutative=True, elementwise=True,
            shm=os.path.isdir("/dev/shm"))
        sel = next((r for r in prs if r["algo"] == picked), best)
        selection.append({
            "coll": coll, "nranks": n, "bytes": nbytes,
            "tuner_selected": sel["algo"], "selected_lat_us": sel["lat_us"],
            "best_algo": best["algo"], "best_lat_us": best["lat_us"],
            "ratio_vs_best": round(sel["lat_us"] / max(best["lat_us"], 1e-9),
                                   4),
        })

    record = {
        "bench": "coll_algos",
        "rows": rows,
        "selection": selection,
        "table": {f"{c}.n{n}": dict(
            (str(th), algo) for th, algo in ent)
            for (c, n), ent in table.items()},
        "elapsed_s": round(time.time() - t_start, 1),
    }
    if out_table:
        write_table(out_table, table,
                    header=f"measured on {os.uname().nodename} "
                           f"nranks={list(nranks_list)}")
        record["table_path"] = os.path.expanduser(out_table)
    if out_json:
        with open(os.path.expanduser(out_json), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m tpu_mpi_torch.tune`` / ``tpurun --tune``. Subcommands:
    ``merge`` (fleet database), ``sentinel`` (committed-artifact regression
    check); default is the measurement sweep."""
    import argparse
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["merge"]:
        return merge_main(argv[1:])
    if argv[:1] == ["sentinel"]:
        return sentinel_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="tpurun --tune",
        description="Measure every collective algorithm on this substrate "
                    "and persist the crossover table select() loads.")
    p.add_argument("--nranks", default="2,4,8",
                   help="comma list of world sizes to sweep (default 2,4,8)")
    p.add_argument("--sizes", default=None,
                   help="comma list of payload bytes "
                        f"(default {','.join(map(str, LADDER))})")
    p.add_argument("--colls", default=",".join(SWEEP_COLLS),
                   help="comma list of collectives to sweep")
    p.add_argument("--scale", type=float, default=1.0,
                   help="iteration-count multiplier (e.g. 0.3 for a quick "
                        "pass)")
    p.add_argument("--quick", action="store_true",
                   help="tiny sweep: 2 ranks, 3 sizes, allreduce+barrier")
    p.add_argument("-o", "--out", default=None,
                   help="tuning-table path (default: $TPU_MPI_TUNE_TABLE "
                        "or ~/.config/tpu_mpi/tune.toml)")
    p.add_argument("--json", default=None,
                   help="also write the full sweep record as JSON")
    p.add_argument("--from-pvars", nargs="+", default=None, metavar="PATH",
                   help="build the table from pvar dump files/dirs "
                        "(TPU_MPI_PVARS_DUMP output) instead of sweeping")
    p.add_argument("--online", nargs="+", default=None, metavar="PATH",
                   help="report the online autotuner's exploration from "
                        "pvar dumps (explored fraction, per-arm samples, "
                        "table swaps) instead of sweeping")
    args = p.parse_args(argv)

    if args.online:
        return _online_report(args.online, json_out=args.json)

    if args.from_pvars:
        out_table = (args.out or config.load().tune_table
                     or os.path.join("~", ".config", "tpu_mpi", "tune.toml"))
        rec = table_from_pvars(args.from_pvars, out_table=out_table)
        if args.json:
            with open(os.path.expanduser(args.json), "w") as f:
                json.dump(rec, f, indent=1)
        print(f"tune: wrote {rec['table_path']} from {len(rec['sources'])} "
              f"pvar dumps ({len(rec['rows'])} measured points)")
        for (sect, ladder) in sorted(rec["table"].items()):
            print(f"  [{sect}] " + "  ".join(
                f"{th}B->{algo}" for th, algo in sorted(
                    ladder.items(), key=lambda kv: int(kv[0]))))
        return 0

    nranks = [int(x) for x in args.nranks.split(",") if x]
    sizes = ([int(x) for x in args.sizes.split(",") if x]
             if args.sizes else list(LADDER))
    colls = [c.strip() for c in args.colls.split(",") if c.strip()]
    if args.quick:
        nranks, sizes = [2], [64, 4096, 65536]
        colls = ["allreduce", "barrier"]
    out_table = (args.out or config.load().tune_table
                 or os.path.join("~", ".config", "tpu_mpi", "tune.toml"))
    rec = autotune(nranks, sizes, colls, scale=args.scale,
                   out_table=out_table, out_json=args.json)
    print(f"tune: wrote {rec['table_path']} "
          f"({len(rec['rows'])} measured points, {rec['elapsed_s']}s)")
    for (sect, ladder) in sorted(rec["table"].items()):
        print(f"  [{sect}] " + "  ".join(
            f"{th}B->{algo}" for th, algo in sorted(
                ladder.items(), key=lambda kv: int(kv[0]))))
    worst = max((s["ratio_vs_best"] for s in rec["selection"]), default=1.0)
    print(f"tune: selected-vs-best worst ratio {worst:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
