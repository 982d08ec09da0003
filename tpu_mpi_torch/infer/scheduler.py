"""Continuous-batching request scheduler for the inference engine (the
port of ``tpu_mpi/infer/scheduler.py``, unchanged in substance).

One daemon thread turns the request stream into :class:`StepPlan`s:

- **Admission**: requests queue FIFO per arrival (the broker's FairQueue
  already ordered them across tenants); the head is admitted when a batch
  slot AND its whole KV-block demand on its home pair are free — paged-KV
  backpressure becomes queueing delay, never a mid-generation failure.
  With ``TPU_MPI_KV_PREFIX_SHARE`` on, admission is also where a request
  adopts registered shared-prefix KV blocks (read-only, copy-on-write):
  the isolation boundary is that a session can only ever match prefixes
  of tokens it presented itself.
- **SLO eviction**: with ``TPU_MPI_INFER_SLO_MS`` set, a request still
  *pending* past its deadline is evicted with the typed, retriable
  :class:`~tpu_mpi_torch.error.SLOExpiredError`; a request that completes is
  booked as an SLO hit or miss against the same deadline.
- **Continuous batching**: every step co-schedules prefill chunks with
  every in-flight decode. ``TPU_MPI_INFER_PREFILL_CHUNK`` bounds the
  prefill tokens per step, splitting giant prompts across consecutive
  plans so they cannot head-of-line-block co-batched decodes.
- **Speculative drafting**: with ``TPU_MPI_INFER_SPEC_K`` > 1, each
  decode feeds up to k rows — the last accepted token plus drafts walked
  from the request's own bigram history (last-occurrence-wins, a pure
  function of its own stream). The engine accepts the greedy-matching
  prefix, so several tokens can ride one round of collectives.

Token values never depend on what else is in a batch (the engine's
row-wise contract), so greedy sequences are bitwise identical whether
requests arrive together or staggered, speculated or not.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from .. import config
from .. import error as _ec
from .. import locksmith
from .. import perfvars
from ..error import MPIError, SessionError, SLOExpiredError
from .engine import Decode, InferEngine, Prefill, StepPlan, PREFILL_TAG_BASE

monotonic = time.monotonic


class InferRequest:
    """One generation request and its outbound token stream. The broker
    handler thread consumes ``out``: ("tok", [ids]) chunks, then one
    ("done", info) or ("err", exception)."""

    __slots__ = ("rid", "tenant", "prompt", "max_new", "slot", "kv_need",
                 "tag", "slo_ms", "deadline", "submitted", "pos",
                 "generated", "out", "state", "pf_done", "pf_chunk",
                 "draft", "spec_fed", "trace")

    def __init__(self, rid: int, tenant: str, prompt: List[int],
                 max_new: int, slot: int, kv_need: int, slo_ms: int):
        self.rid = rid
        self.tenant = tenant
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.slot = slot
        self.kv_need = kv_need
        self.tag = 0
        self.slo_ms = int(slo_ms)
        self.submitted = monotonic()
        self.deadline = (self.submitted + self.slo_ms / 1e3
                         if self.slo_ms > 0 else None)
        self.pos = 0                      # next feed position (set at prefill)
        self.pf_done = 0                  # prompt tokens already in KV
        self.pf_chunk = 0                 # tokens in the in-flight chunk
        self.generated: List[int] = []
        # bigram draft table over this request's own stream
        # (last-occurrence-wins); seeded from the prompt
        self.draft: Dict[int, int] = {a: b for a, b
                                      in zip(self.prompt, self.prompt[1:])}
        self.spec_fed = 1
        self.out: "queue.Queue" = queue.Queue()
        self.state = "pending"
        self.trace = None                 # TraceCtx of a sampled request

    def fail(self, exc: BaseException) -> None:
        if self.state in ("done", "failed"):
            return
        self.state = "failed"
        self.out.put(("err", exc))

    def finish(self, info: dict) -> None:
        self.state = "done"
        self.out.put(("done", info))


class InferScheduler:
    """The continuous-batching loop over one :class:`InferEngine`."""

    def __init__(self, engine: InferEngine, *,
                 max_batch: Optional[int] = None,
                 slo_ms: Optional[int] = None):
        knobs = config.load()
        self.engine = engine
        self.max_batch = max(1, int(engine.max_batch if max_batch is None
                                    else max_batch))
        self.slo_ms = int(knobs.infer_slo_ms if slo_ms is None else slo_ms)
        self._lock = locksmith.make_lock("infer.scheduler")
        self._pending: Deque[InferRequest] = deque()
        self._prefilling: List[InferRequest] = []
        self._active: List[InferRequest] = []
        self._releases: List[InferRequest] = []
        self._rid = itertools.count(1)
        self._seq = itertools.count(0)
        self._stream = itertools.count(0)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._paused = threading.Event()     # elastic quiesce requested
        self._boundary = threading.Event()   # loop parked between steps
        self._dead: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self.counters = {"admitted": 0, "completed": 0, "cancelled": 0,
                         "slo_evictions": 0, "slo_hits": 0, "slo_misses": 0,
                         "steps": 0, "step_ns": 0, "tokens": 0,
                         "batch_slots": 0, "prefill_tokens": 0,
                         "spec_drafted": 0, "spec_accepted": 0,
                         "prefix_hit_tokens": 0, "prefix_miss_tokens": 0}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="infer-sched", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        exc = SessionError("inference engine shutting down")
        with self._lock:
            doomed = (list(self._pending) + list(self._prefilling)
                      + list(self._active))
            self._pending.clear()
            self._prefilling.clear()
            self._active.clear()
        for r in doomed:
            r.fail(exc)

    # -- intake --------------------------------------------------------------
    def submit(self, tenant: str, prompt: List[int],
               max_new: int, tctx=None) -> InferRequest:
        """Queue one generation request (validation is the broker's job);
        returns immediately — tokens stream through ``req.out``."""
        if self._dead is not None:
            raise MPIError(f"inference engine is down: {self._dead}",
                           code=_ec.ERR_OTHER)
        rid = next(self._rid)
        slot = (rid - 1) % self.engine.ep
        need = self.engine.kv_demand(len(prompt), max_new)
        req = InferRequest(rid, tenant, prompt, max_new, slot, need,
                           self.slo_ms)
        req.trace = tctx
        with self._lock:
            self._pending.append(req)
        self._wake.set()
        return req

    def cancel_tenant(self, tenant: str) -> int:
        """Evict every request of a revoked tenant: pending ones fail
        immediately, in-flight ones leave the batch and their KV chains
        are released on the next step. Survivor tenants never notice —
        shared prefix blocks they adopted stay alive under their own
        references."""
        exc = SessionError(f"lease for tenant {tenant!r} revoked "
                           f"mid-generation")
        with self._lock:
            dropped = [r for r in self._pending if r.tenant == tenant]
            self._pending = deque(r for r in self._pending
                                  if r.tenant != tenant)
            victims = [r for r in self._prefilling + self._active
                       if r.tenant == tenant]
            self._prefilling = [r for r in self._prefilling
                                if r.tenant != tenant]
            self._active = [r for r in self._active if r.tenant != tenant]
            for r in victims:
                r.state = "cancelled"
                self._releases.append(r)
            self.counters["cancelled"] += len(dropped) + len(victims)
        for r in dropped + victims:
            r.fail(exc)
        self._wake.set()
        return len(dropped) + len(victims)

    # -- the batching loop ---------------------------------------------------
    def _evict_expired(self, now: float) -> None:
        still: Deque[InferRequest] = deque()
        for r in self._pending:
            if r.deadline is not None and now > r.deadline:
                self.counters["slo_evictions"] += 1
                if perfvars.enabled():
                    perfvars.note_infer(slo_evictions=1)
                r.fail(SLOExpiredError(
                    f"request rid={r.rid} waited past its "
                    f"{r.slo_ms}ms SLO deadline without being scheduled "
                    f"(engine saturated) — retry under lighter load",
                    tenant=r.tenant, rid=r.rid, slo_ms=r.slo_ms))
            else:
                still.append(r)
        self._pending = still

    def _draft_feed(self, r: InferRequest) -> List[int]:
        """The decode feed for one request: last accepted token plus up to
        k-1 bigram drafts, never past its max_new budget."""
        feed = [r.generated[-1]]
        k = min(self.engine.spec_k, r.max_new - len(r.generated))
        cur = feed[0]
        while len(feed) < k:
            nxt = r.draft.get(cur)
            if nxt is None:
                break
            feed.append(nxt)
            cur = nxt
        r.spec_fed = len(feed)
        return feed

    def _build_plan(self) -> Optional[tuple]:
        """Under the lock: evict, admit, snapshot one step. Returns
        (plan, prefills, decodes, releases) or None when idle."""
        self._evict_expired(monotonic())
        budget = self.engine.prefill_chunk or None   # None = unbounded
        prefills: List[InferRequest] = []
        # continuing chunked prefills first (FIFO by admission)
        for r in self._prefilling:
            if budget is not None and budget <= 0:
                break
            remaining = len(r.prompt) - r.pf_done
            take = remaining if budget is None else min(remaining, budget)
            if take <= 0:
                continue
            if budget is not None:
                budget -= take
            r.pf_chunk = take
            r.tag = PREFILL_TAG_BASE + next(self._stream) % 4096
            prefills.append(r)
        # fresh admissions under slot + KV + prefill-budget pressure
        while (self._pending
               and (len(self._active) + len(self._prefilling)
                    < self.max_batch)
               and (budget is None or budget > 0)):
            head = self._pending[0]
            if not self.engine.can_admit(head.slot, head.kv_need):
                break                     # KV backpressure: FIFO holds
            self._pending.popleft()
            self.engine.reserve(head.slot, head.kv_need)
            hit = self.engine.kv_prefix_acquire(head.rid, head.slot,
                                               head.prompt)
            head.pf_done = hit
            self.counters["prefix_hit_tokens"] += hit
            self.counters["prefix_miss_tokens"] += len(head.prompt) - hit
            if perfvars.enabled():
                perfvars.note_infer(kv_prefix_hit_tokens=hit,
                                    kv_prefix_miss_tokens=(len(head.prompt)
                                                           - hit))
            remaining = len(head.prompt) - hit
            take = remaining if budget is None else min(remaining, budget)
            if budget is not None:
                budget -= take
            head.pf_chunk = take
            head.tag = PREFILL_TAG_BASE + next(self._stream) % 4096
            head.state = "running"
            self.counters["admitted"] += 1
            self._prefilling.append(head)
            prefills.append(head)
        decodes = list(self._active)
        releases = self._releases
        self._releases = []
        if not prefills and not decodes and not releases:
            if not self._prefilling:
                self._wake.clear()
            return None
        share = self.engine.prefix_share
        plan = StepPlan(
            next(self._seq),
            [Prefill(r.rid, r.slot,
                     r.prompt[r.pf_done:r.pf_done + r.pf_chunk], r.tag,
                     pos0=r.pf_done,
                     last=(r.pf_done + r.pf_chunk == len(r.prompt)),
                     register=(r.prompt if share else None))
             for r in prefills],
            [Decode(r.rid, r.slot, self._draft_feed(r), r.pos)
             for r in decodes],
            [r.rid for r in releases])
        plan.trace = next((r.trace for r in prefills + decodes
                           if r.trace is not None), None)
        return plan, prefills, decodes, releases

    def pause(self, timeout: float = 30.0) -> bool:
        """Park the batching loop at a step boundary (the elastic rebind
        quiesce): requests keep queueing and SLO deadlines keep ticking —
        a request whose deadline passes while paused is evicted at resume —
        but nothing touches the engine until :meth:`resume`. Returns True
        once the loop is parked (no step mid-flight)."""
        self._paused.set()
        self._wake.set()
        return self._boundary.wait(timeout)

    def resume(self) -> None:
        self._paused.clear()
        self._boundary.clear()
        self._wake.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.2)
            if self._stop.is_set():
                return
            if self._paused.is_set():
                self._boundary.set()
                time.sleep(0.01)
                continue
            with self._lock:
                built = self._build_plan()
            if built is None:
                continue
            plan, prefills, decodes, releases = built
            t0 = time.perf_counter_ns()
            try:
                results = self.engine.run_step(plan)
            except BaseException as e:      # noqa: BLE001 - engine is down
                self._dead = e
                with self._lock:
                    doomed = (prefills + decodes + list(self._pending)
                              + [r for r in self._prefilling
                                 if r not in prefills])
                    self._pending.clear()
                    self._prefilling.clear()
                    self._active.clear()
                for r in doomed:
                    r.fail(e if isinstance(e, MPIError) else
                           MPIError(f"inference step failed: {e!r}",
                                    code=_ec.ERR_OTHER))
                return
            step_ns = time.perf_counter_ns() - t0
            self._book_step(plan, prefills, decodes, releases, results,
                            step_ns)

    def _book_step(self, plan, prefills, decodes, releases, results,
                   step_ns) -> None:
        emitted = 0
        drafted = accepted = 0
        now = monotonic()
        with self._lock:
            for r in releases:
                self.engine.unreserve(r.slot, r.kv_need)
            for r in prefills:
                r.pf_done += r.pf_chunk
                r.pf_chunk = 0
            for r in prefills + decodes:
                if r.state != "running":
                    continue              # cancelled while the step ran
                if r in prefills:
                    if r.pf_done < len(r.prompt):
                        continue          # chunked prefill still going
                    r.pos = len(r.prompt)  # first decode feeds at this pos
                toks = results.get(r.rid)
                if not toks:
                    continue
                if r in prefills:
                    self._prefilling.remove(r)
                    self._active.append(r)
                else:
                    toks = toks[:r.max_new - len(r.generated)]
                    r.pos += len(toks)
                    self.counters["spec_drafted"] += r.spec_fed - 1
                    self.counters["spec_accepted"] += len(toks) - 1
                    drafted += r.spec_fed - 1
                    accepted += len(toks) - 1
                # extend the bigram draft table along the accepted stream
                prev = (r.generated[-1] if r.generated
                        else (r.prompt[-1] if r.prompt else None))
                for t in toks:
                    if prev is not None:
                        r.draft[prev] = t
                    prev = t
                r.generated.extend(toks)
                emitted += len(toks)
                r.out.put(("tok", list(toks)))
                if len(r.generated) >= r.max_new:
                    self._active.remove(r)
                    self._releases.append(r)
                    hit = r.deadline is None or now <= r.deadline
                    self.counters["slo_hits" if hit else "slo_misses"] += 1
                    self.counters["completed"] += 1
                    if perfvars.enabled():
                        perfvars.note_infer(
                            **{"slo_hits" if hit else "slo_misses": 1})
                    r.finish({"total_tokens": len(r.generated),
                              "slo_hit": hit,
                              "latency_ms": round((now - r.submitted) * 1e3,
                                                  3)})
            self.counters["steps"] += 1
            self.counters["step_ns"] += step_ns
            self.counters["tokens"] += emitted
            self.counters["batch_slots"] += len(prefills) + len(decodes)
            self.counters["prefill_tokens"] += sum(len(p.tokens)
                                                   for p in plan.prefills)
            if self._pending or self._releases or self._prefilling:
                self._wake.set()
        if perfvars.enabled():
            perfvars.note_infer(steps=1, step_ns=step_ns, tokens=emitted,
                                batch_slots=len(prefills) + len(decodes),
                                prefills=len(prefills),
                                spec_drafted=drafted, spec_accepted=accepted)
            kv = self.engine.kv_stats()
            perfvars.set_infer_gauges(
                max_batch=self.max_batch,
                spec_k=self.engine.spec_k,
                kv_blocks_per_rank=kv["blocks_per_rank"],
                kv_in_use_max=kv["in_use_max"],
                kv_peak_in_use_max=kv["peak_in_use_max"],
                kv_alloc_failures=kv["alloc_failures"],
                kv_shared_blocks_max=kv["shared_blocks_max"],
                kv_prefix_entries_max=kv["prefix_entries_max"],
                kv_cow_forks=kv["cow_forks"])

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            c = dict(self.counters)
            pending = len(self._pending)
            active = len(self._active) + len(self._prefilling)
        finished = c["slo_hits"] + c["slo_misses"]
        decode_s = c["step_ns"] / 1e9
        rounds = self.engine.moe_rounds
        probed = c["prefix_hit_tokens"] + c["prefix_miss_tokens"]
        return {
            "max_batch": self.max_batch, "slo_ms": self.slo_ms,
            "pending": pending, "active": active,
            "paused": self._paused.is_set(), **c,
            "tokens_per_s": (round(c["tokens"] / decode_s, 3)
                             if decode_s > 0 else None),
            "batch_occupancy": (round(c["batch_slots"]
                                      / (c["steps"] * self.max_batch), 4)
                                if c["steps"] else None),
            "slo_hit_rate": (round(c["slo_hits"] / finished, 4)
                             if finished else None),
            "decode": {
                "vectorized": self.engine.vectorized,
                "spec_k": self.engine.spec_k,
                "prefill_chunk": self.engine.prefill_chunk,
                "moe_rounds": rounds,
                "rounds_per_token": (round(rounds / c["tokens"], 4)
                                     if c["tokens"] else None),
                "drafted": c["spec_drafted"],
                "accepted": c["spec_accepted"],
                "accept_rate": (round(c["spec_accepted"]
                                      / c["spec_drafted"], 4)
                                if c["spec_drafted"] else None),
            },
            "kv": {
                **self.engine.kv_stats(),
                "prefix_share": self.engine.prefix_share,
                "prefix_hit_tokens": c["prefix_hit_tokens"],
                "prefix_miss_tokens": c["prefix_miss_tokens"],
                "prefix_hit_rate": (round(c["prefix_hit_tokens"] / probed, 4)
                                    if probed else None),
            },
        }
