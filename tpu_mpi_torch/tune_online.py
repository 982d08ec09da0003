"""Online bandit autotuner: live-traffic algorithm selection with hot-swap.

The offline tuner (:mod:`tpu_mpi_torch.tune`) measures offline and serves a static
crossover table; this module closes ROADMAP item 4's loop by tuning *while
serving*. An epsilon-greedy bandit sits at the single algorithm decision
point (``collective._coll_select`` callers route through
:meth:`Online.decide`): on a configurable fraction of live collective
calls (``TPU_MPI_TUNE_EXPLORE``, default off) the call runs an eligible
alternate algorithm instead of the steady selection, the pvar op scope
(:mod:`tpu_mpi_torch.perfvars`) attributes the observed latency to that
``(coll, algo, nbytes, nranks)`` arm as it already does for every
collective, and every ``TPU_MPI_TUNE_SWAP_PERIOD`` decisions the loop
recomputes the crossover table from the accumulated arm statistics and
hot-swaps it through the existing config-generation invalidation of the
selection memo and plan cache — no restart, no extra barrier.

**Lockstep safety (the invariant that makes this sound).** Every tier
gate in this engine is a deterministic function of rank-uniform values so
ranks can never pick different protocols for one round; exploration must
preserve that. Three pieces do:

1. *Deterministic schedule.* Whether call ``c`` of a decision key
   explores is ``int(c * eps) > int((c - 1) * eps)`` — a pure function of
   the per-(rank, cid, coll, nbytes) call counter, which advances
   identically on every rank because MPI programs issue the identical
   collective sequence per communicator.
2. *Shared seeded arm choice.* The explored arm is
   ``alts[crc32(seed|coll|nbytes|nranks|index) % len(alts)]`` — CRC32,
   not Python's per-process-randomized ``hash``, over rank-uniform
   inputs, so all ranks land on the same alternate.
3. *Lockstep table swap.* At a swap milestone every rank reaches the same
   internal collective round (an ordinary rendezvous over the comm) that
   allgathers per-rank arm stats; each rank merges the IDENTICAL
   cross-rank totals and derives the IDENTICAL table. Divergent tables
   are impossible by construction, not by coincidence of timing.

Registered-buffer persistent plans (``Allreduce_init`` rounds) bypass the
per-call decision point by design and therefore never explore; they pick
up a swapped table at their next generation rebind. AUTO-ARMED plans
(a plain ``Allreduce`` loop promoted onto the registered path
by ``collective._auto_arm_gate``) inherit the same rule structurally —
the armed runner returns before ``_explore_reduce_variant`` is ever
consulted. Lockstep survives the combination: arming is a deterministic
function of the per-rank call stream (identical across ranks in an SPMD
program), so every rank stops reaching the decision point at the same
call, and under tracing every rank demotes together (trace enablement is
config-global), keeping per-call ``Event.algo`` sequences rank-identical
with auto-arm and ``TPU_MPI_TUNE_EXPLORE`` both on.

The fleet angle — ``python -m tpu_mpi_torch.tune merge`` folding per-rank pvar
dumps and measured tables into one shared database ``select()`` loads —
lives in :mod:`tpu_mpi_torch.tune` (schema 2); this module is the in-process
loop only.
"""

from __future__ import annotations

import sys
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from . import config
from . import perfvars as _pv
from . import tune

__all__ = ["Online", "state", "table", "reset"]

_UNSET = object()
_state_cache: Tuple[object, Optional["Online"]] = (_UNSET, None)
_singleton: Optional["Online"] = None
_warned_pvars = False

# The in-memory hot-swap table, same shape as ``tune.load_table``:
# {(coll, nranks): [(min_bytes, algo), ...]}. Swaps rebind the whole dict
# (never mutate in place) so concurrent readers walk a consistent table.
_table: Dict[Tuple[str, int], List[Tuple[int, str]]] = {}


def table() -> Optional[Dict[Tuple[str, int], List[Tuple[int, str]]]]:
    """The current online crossover table (consulted by ``tune.select``
    between the force-override and the static table layers), or None
    before the first swap."""
    return _table or None


def state() -> Optional["Online"]:
    """The live bandit, or None when exploration is off. Cached on
    ``config.GENERATION`` (the ``perfvars.enabled`` discipline): the
    default exploration-off run pays one tuple compare per decision."""
    global _state_cache, _singleton, _warned_pvars
    cached_gen, st = _state_cache
    if cached_gen == config.GENERATION:
        return st
    cfg = config.load()
    st = None
    if cfg.tune_explore > 0.0:
        if _singleton is None:
            _singleton = Online()
        _singleton.reconfigure(cfg)
        st = _singleton
        if not _pv.enabled() and not _warned_pvars:
            _warned_pvars = True
            print("tpu_mpi_torch: TPU_MPI_TUNE_EXPLORE is set but pvar collection "
                  "is off — the online autotuner explores blind and can "
                  "never swap the table; set TPU_MPI_PVARS=1",
                  file=sys.stderr)
    _state_cache = (config.GENERATION, st)
    return st


class _TLS(threading.local):
    internal = False          # inside the lockstep swap round


class Online:
    """Epsilon-greedy bandit over ``tune.PORTFOLIO``.

    Counters are keyed per **rank** (thread-tier ranks share this process,
    so a process-global counter would advance size-times per round and
    desynchronize the schedule): ``(rank, cid, coll, nbytes)`` for the
    per-key exploration schedule and ``(rank, cid)`` for swap milestones.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.eps = 0.0
        self.seed = 0
        self.swap_period = 256
        self.min_samples = 8
        self.counts: Dict[Tuple, int] = {}
        self.totals: Dict[Tuple[int, int], int] = {}
        # cid -> (milestone, changed, generation): the recorded outcome of
        # the latest swap round, read by thread-tier sibling ranks so their
        # per-rank swap pvars stay identical (see _swap)
        self._applied: Dict[int, Tuple[int, bool, int]] = {}
        self.swaps = 0
        self._tls = _TLS()

    def reconfigure(self, cfg) -> None:
        """Refresh knobs on a config reload; counters survive so the loop
        keeps its schedule position across its own hot-swaps."""
        self.eps = min(1.0, max(0.0, float(cfg.tune_explore)))
        self.seed = int(cfg.tune_seed)
        self.swap_period = max(1, int(cfg.tune_swap_period))
        self.min_samples = max(1, int(cfg.tune_min_samples))

    def decide(self, comm, coll: str, nbytes: Optional[int], steady: str, *,
               commutative: bool = False, elementwise: bool = False,
               numeric: bool = True, shm: bool = False,
               domains: int = 0) -> str:
        """One algorithm decision on the live path: returns ``steady`` or,
        on this key's deterministic exploration slots, the seeded eligible
        alternate. Ticks the lockstep counters and runs the table-swap
        round at milestones."""
        from ._runtime import current_env
        env = current_env()
        if env is None or self._tls.internal:
            return steady
        nranks = comm.size()
        if nranks < 2:
            return steady
        if coll in tune.parse_override(config.load().coll_algo):
            # a force-pinned collective is never explored: the pin is a
            # debugging/CI contract, and both caches make this check cheap
            return steady
        rank = env[1]
        nb_key = -1 if nbytes is None else int(nbytes)
        key = (rank, comm.cid, coll, nb_key)
        tkey = (rank, comm.cid)
        with self.lock:
            c = self.counts.get(key, 0) + 1
            self.counts[key] = c
            total = self.totals.get(tkey, 0) + 1
            self.totals[tkey] = total
        # explore iff the integer part of c*eps advanced at this call — a
        # deterministic ~eps-fraction schedule with no RNG state to drift
        ei = int(c * self.eps)
        algo = steady
        if ei > int((c - 1) * self.eps):
            alts = [a for a in tune.candidates(
                        coll, nranks, nbytes, commutative=commutative,
                        elementwise=elementwise, shm=shm, numeric=numeric,
                        domains=domains)
                    if a != steady]
            if alts:
                h = zlib.crc32(
                    f"{self.seed}|{coll}|{nb_key}|{nranks}|{ei}".encode())
                algo = alts[h % len(alts)]
        if _pv.enabled():
            _pv.note_explore(comm, algo != steady)
        if total % self.swap_period == 0:
            self._swap(comm, total // self.swap_period)
        return algo

    # -- the lockstep hot-swap round ----------------------------------------

    def _swap(self, comm, milestone: int) -> None:
        """Allgather per-rank arm stats over ``comm`` (an ordinary internal
        rendezvous — every rank reaches this milestone at the same program
        point), merge them, recompute the crossover table, and hot-swap it
        through a config-generation bump when it changed."""
        global _table
        from .collective import _run
        self._tls.internal = True
        try:
            local = _pv.arm_stats(comm)
            merged = _run(comm, local, _merge_arm_stats,
                          f"TuneSwap@{comm.cid}")
        finally:
            self._tls.internal = False
        nranks = comm.size()
        rows = []
        for coll, algo, nbytes, cnt, total_ns in merged:
            if (coll not in tune.PORTFOLIO or cnt < self.min_samples
                    or algo not in tune.PORTFOLIO[coll]):
                continue
            rows.append({"coll": coll, "nranks": nranks,
                         "bytes": max(0, int(nbytes)), "algo": algo,
                         "lat_us": total_ns / cnt / 1e3})
        new_entries = tune._crossovers(rows)
        # Thread-tier ranks share this process (and ``_table``), so the
        # rebind must not be raced: the first rank through a milestone
        # applies it and records the outcome; siblings read the record.
        # That keeps per-rank swap pvars identical and bumps the config
        # generation once per swap, not once per rank. (A rank cannot see
        # a stale slot from the NEXT milestone: overwriting it requires
        # every rank to have passed this milestone's rendezvous first.)
        with self.lock:
            slot = self._applied.get(comm.cid)
            if slot is None or slot[0] != milestone:
                updated = dict(_table)
                changed = False
                for k, ent in new_entries.items():
                    if updated.get(k) != ent:
                        updated[k] = ent
                        changed = True
                if changed:
                    _table = updated          # atomic rebind, then:
                    config.load(refresh=True)  # selection memo misses now
                    self.swaps += 1
                slot = (milestone, changed, config.GENERATION)
                self._applied[comm.cid] = slot
        _, changed, gen = slot
        if changed and _pv.enabled():
            _pv.note_swap(comm, gen)


def _merge_arm_stats(contribs):
    """Combine closure of the swap round: sum per-rank ``(coll, algo,
    nbytes) -> (count, total_ns)`` stats — sample-count-weighted by
    construction — and hand every rank the identical sorted merge."""
    acc: Dict[Tuple[str, str, int], List[int]] = {}
    for rows in contribs:
        for coll, algo, nbytes, cnt, total_ns in rows:
            ent = acc.setdefault((coll, algo, int(nbytes)), [0, 0])
            ent[0] += int(cnt)
            ent[1] += int(total_ns)
    merged = sorted((c, a, b, v[0], v[1]) for (c, a, b), v in acc.items())
    return [merged] * len(contribs)


def reset() -> None:
    """Drop the bandit, its counters, and the online table (tests)."""
    global _state_cache, _singleton, _table, _warned_pvars
    _state_cache = (_UNSET, None)
    _singleton = None
    _table = {}
    _warned_pvars = False
