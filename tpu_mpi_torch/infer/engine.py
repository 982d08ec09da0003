"""Expert-parallel MoE inference executor on the serve tier's warm pool
(the port of ``tpu_mpi/infer/engine.py``).

Topology: the pool's R ranks split into 2 pipeline stages of ``ep = R//2``
experts each — stage 0 owns layers ``[0, L/2)`` on ranks ``[0, ep)``,
stage 1 owns ``[L/2, L)`` on ranks ``[ep, R)``; rank ``s`` pairs with rank
``s + ep``. Every admitted request has a *home slot* ``s``: its KV chains
and attention run on the pair ``(s, s + ep)``, while its MoE FFN tokens
route to whichever expert rank the gate picks via
:func:`tpu_mpi_torch.parallel.ep.moe_host_dispatch_combine` — two Alltoallv
rendezvous plus a count Alltoall per layer round, all passing through
the algorithm-selection layer and the online bandit's decision point.

Decode fast path (docs/serving.md "Decode fast path"):

- **Vectorized dispatch** (``TPU_MPI_INFER_VECTORIZED``, default on):
  every co-batched prefill advances partition-p-for-everyone per round,
  so one step makes ONE batched Alltoallv dispatch + one combine per
  layer round with all requests' rows concatenated and per-peer counts
  taken from the whole batch — instead of one round per request per
  partition. Decode rows were already co-batched per layer.
- **Speculative multi-token decode** (``TPU_MPI_INFER_SPEC_K``): a
  :class:`Decode` feeds up to k token rows per request (last accepted
  token + k-1 drafted); stage 1 accepts the longest prefix where each
  drafted token equals the greedy output one row earlier, so every
  accepted token is bitwise the k=1 token. Rejected rows' KV is rolled
  back by the next plan's authoritative ``pos`` (no extra rendezvous).
- **KV prefix sharing** (``TPU_MPI_KV_PREFIX_SHARE``): admission adopts
  registered prompt-prefix blocks (:meth:`kv_prefix_acquire`) so prefill
  only computes the divergent suffix.

Determinism contract (the scheduler-order-independence acceptance): every
batch-size-dependent reduction is forbidden. Attention is computed one
token row at a time against that session's own KV; experts apply row-wise
inside the dispatcher; the MoE capacity always covers a sender's worst
case, so no token is ever dropped by co-batching. A request's token
sequence is a function of its prompt and the model alone — which is the
left-fold composition argument for why the batched dispatch, the
speculative verify pass, and an adopted shared prefix all reproduce the
row-loop k=1 private-KV stream bitwise.

Rank-uniformity contract: all R ranks execute the SAME :class:`StepPlan`,
so every rank makes the identical sequence of collective calls per step —
non-home ranks contribute zero token rows, chunk boundaries and prefix
hit lengths ride in the plan. That is what lets prefill and decode
co-batch freely without collective-order divergence (T201/T202).

Prefill streams stage 0 -> stage 1 through the partitioned-op machinery
(:class:`~tpu_mpi_torch.infer.kvcache.PartitionStreamWriter` /
``PartitionStreamReader``): stage 1 attends over prompt block p while
stage 0 is still computing block p+1. Decode hidden states cross stages
as one plain Send/Recv per step, counts known from the shared plan.

Port mapping: every rank's weights, KV caches and rows are tensors on the
pool's device (``cuda`` unless the broker was asked for ``cpu``); only the
routing (the gate's argmax, once a round), the sampled token ids (once a
step for all of a rank's rows) and the count exchange come to the host.
The row math keeps the reference's formulas and float32 dtypes (numpy 2's
promotion: the RoPE angles are float32, the RMS epsilon is added to a
float32 mean), and its shapes: every product takes ONE row, so a row's
kernels — and its bits — never depend on what shares its batch. That is
what carries the determinism contract above onto the card, where a product
of k rows may take another kernel (another summation order) for another
k. The RoPE tables are computed once, on the host, with the reference's
numpy expression, position by position.

Parameters: by default :func:`~tpu_mpi_torch.models.transformer.
transformer_pp_moe_init` from a CPU ``torch.Generator`` seeded by ``seed``
(the same weights on every device). To carry weights across from the JAX
package — the parity tests' route — pass ``params=``, its layer-stacked
pytree as numpy arrays (``params_from_jax``), sliced per rank as
``transformer_pp_moe_host_params`` does, onto the device.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import config
from .. import locksmith
from .. import perfvars
from ..error import MPIError
from .. import error as _ec
from ..buffers import resolve_device
from .kvcache import PagedKVCache, PartitionStreamReader, PartitionStreamWriter

PREFILL_TAG_BASE = 0x5A00     # + stream ordinal % 4096 (partitioned tags)
DECODE_TAG_BASE = 0x4D00      # + step seq % 4096 (plain Send/Recv)
N_STAGES = 2


class Prefill:
    """One prompt chunk of one request: ``tokens`` starting at global
    position ``pos0`` (> 0 after a prefix-share hit or an earlier chunk);
    ``last`` marks the chunk that produces the first sampled token;
    ``register`` carries the full prompt for prefix-registry publication
    on the home pair (None = sharing off)."""

    __slots__ = ("rid", "slot", "tokens", "tag", "pos0", "last", "register")

    def __init__(self, rid: int, slot: int, tokens: List[int], tag: int,
                 pos0: int = 0, last: bool = True,
                 register: Optional[List[int]] = None):
        self.rid, self.slot, self.tokens, self.tag = rid, slot, tokens, tag
        self.pos0, self.last, self.register = int(pos0), bool(last), register


class Decode:
    """One decode feed of one request: ``tokens[0]`` is the last accepted
    token, the rest are speculative drafts; ``pos`` is the global position
    of ``tokens[0]`` AND the authoritative KV length — every rank rolls
    the session's chains back to ``pos`` before feeding (the speculative
    rejection rollback, no extra rendezvous needed)."""

    __slots__ = ("rid", "slot", "tokens", "pos")

    def __init__(self, rid: int, slot: int, tokens, pos: int):
        self.rid, self.slot, self.pos = rid, slot, pos
        self.tokens = [int(tokens)] if np.isscalar(tokens) else \
            [int(t) for t in tokens]

    @property
    def token(self) -> int:
        return self.tokens[0]


class StepPlan:
    """One continuous-batching step, identical on every rank: prefills
    then decodes (both rid-ordered), plus sessions to release."""

    __slots__ = ("seq", "prefills", "decodes", "releases", "trace")

    def __init__(self, seq: int, prefills: List[Prefill],
                 decodes: List[Decode], releases: List[int]):
        self.seq = seq
        self.prefills = sorted(prefills, key=lambda p: p.rid)
        self.decodes = sorted(decodes, key=lambda d: d.rid)
        self.releases = sorted(releases)
        # request tracing: the context of one traced request in this batch
        # (the step is shared, so its rank phase spans attribute to it)
        self.trace = None


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of the reference, not ``F.gelu``."""
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654
                                       * (x + 0.044715 * x * x * x)))


def _rms_row(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / torch.sqrt(torch.mean(x * x) + 1e-6)) * scale


def _softmax_row(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(x - x.max())
    return e / e.sum()


def _rope_tables(max_seq: int, head_dim: int, device) -> tuple:
    """``(cos, sin)``, each ``(max_seq, head_dim // 2)`` float32 on
    ``device``: row ``pos`` is the reference's ``_rope_row`` angle table
    at ``pos``, computed by its own numpy expression one position at a
    time (so numpy's float32 cos/sin round each angle as it does there)."""
    half = head_dim // 2
    cos = np.empty((max_seq, half), np.float32)
    sin = np.empty_like(cos)
    for pos in range(max_seq):
        ang = pos / (10000.0 ** (np.arange(half, dtype=np.float32)
                                 / np.float32(half)))
        cos[pos], sin[pos] = np.cos(ang), np.sin(ang)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def _rope_row(x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of one token's (h, dh) heads, given its position's
    rows of the :func:`_rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class InferEngine:
    """The per-rank model shards + KV caches + step executor. Owned by the
    broker; driven one :class:`StepPlan` at a time by the scheduler."""

    def __init__(self, pool, cfg=None, *, seed: int = 0,
                 max_batch: Optional[int] = None,
                 block_tokens: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 vectorized: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_share: Optional[bool] = None,
                 params: Optional[dict] = None):
        from ..models.transformer import TransformerConfig
        nr = pool.nranks
        if nr < 2 or nr % 2:
            raise MPIError(
                f"inference engine needs an even warm pool of >= 2 ranks "
                f"(2 pipeline stages x ep experts), got {nr}",
                code=_ec.ERR_ARG)
        knobs = config.load()
        self.pool = pool
        # the pool's device: the engine's tensors live where its folds do
        self.device = resolve_device(getattr(pool, "device", None))
        self._params = params
        self.ep = nr // 2
        # world ranks hosting the engine, comm order: stage 0 is ranks[:ep],
        # stage 1 is ranks[ep:]. An elastic resize replaces entries in place
        # (rebind), so all comm-relative addressing (slots, p2p peers) holds.
        self.ranks = tuple(range(nr))
        self.cfg = cfg or TransformerConfig(vocab=64, d_model=32, n_heads=2,
                                            n_layers=2, d_ff=64, max_seq=128)
        if self.cfg.n_layers % N_STAGES:
            raise MPIError(f"n_layers={self.cfg.n_layers} must split over "
                           f"{N_STAGES} pipeline stages", code=_ec.ERR_ARG)
        self.layers_local = self.cfg.n_layers // N_STAGES
        self.seed = int(seed)
        self.max_batch = max(1, int(knobs.infer_max_batch
                                    if max_batch is None else max_batch))
        self.block_tokens = max(1, int(knobs.kv_block_tokens
                                       if block_tokens is None
                                       else block_tokens))
        self.vectorized = bool(knobs.infer_vectorized
                               if vectorized is None else vectorized)
        self.spec_k = max(1, int(knobs.infer_spec_k
                                 if spec_k is None else spec_k))
        self.prefill_chunk = max(0, int(knobs.infer_prefill_chunk
                                        if prefill_chunk is None
                                        else prefill_chunk))
        self.prefix_share = bool(knobs.kv_prefix_share
                                 if prefix_share is None else prefix_share)
        if kv_blocks is None:
            per_sess = self.layers_local * math.ceil(self.cfg.max_seq
                                                     / self.block_tokens)
            kv_blocks = self.max_batch * per_sess
        self.kv_blocks = int(kv_blocks)
        self._state: Dict[int, dict] = {}
        self._reserved = [0] * self.ep
        self._resv_lock = locksmith.make_lock("infer.reservations")
        self.moe_rounds = 0           # dispatch/combine rounds, both stages
        self._rounds_lock = locksmith.make_lock("infer.rounds")
        self.wcomm = None
        self.ep_comms = (None, None)
        self._rope = None
        # {rid: [final-row logits, one float32 numpy row a sampled token]}
        # when set to a dict: the parity checks' view of the logits (one
        # device-to-host copy a sampled row while on)
        self.logit_log: Optional[Dict[int, list]] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Build engine comms and per-rank shards; the pool must be warm."""
        from ..comm import Comm
        from ..models.transformer import (params_from_jax,
                                          transformer_pp_moe_host_params,
                                          transformer_pp_moe_init)
        ctx = self.pool.ctx
        self.wcomm = Comm(self.ranks, ctx.alloc_cid(), ctx=ctx,
                          name="infer-world")
        self.ep_comms = (
            Comm(self.ranks[:self.ep], ctx.alloc_cid(), ctx=ctx,
                 name="infer-ep0"),
            Comm(self.ranks[self.ep:], ctx.alloc_cid(), ctx=ctx,
                 name="infer-ep1"))
        dev = self.device
        if self._params is None:
            params = transformer_pp_moe_init(
                torch.Generator().manual_seed(self.seed), self.cfg, self.ep,
                device=dev)
        elif all(isinstance(v, torch.Tensor) for v in self._params.values()):
            params = self._params
        else:
            params = params_from_jax(self._params, self.cfg, dev)
        self._params = None                  # the shards below hold them
        self._rope = _rope_tables(self.cfg.max_seq, self.cfg.head_dim, dev)
        for i, r in enumerate(self.ranks):
            stage, slot = (0, i) if i < self.ep else (1, i - self.ep)
            self._state[r] = {
                "stage": stage, "slot": slot,
                "sp": transformer_pp_moe_host_params(
                    params, self.cfg, self.ep, stage, N_STAGES, slot,
                    device=dev),
                "kv": PagedKVCache(self.kv_blocks, self.block_tokens,
                                   self.cfg.n_heads, self.cfg.head_dim,
                                   device=dev),
            }

    def rebind(self, mapping: dict) -> None:
        """Point the engine at replacement world ranks after an elastic
        resize (``mapping``: dead world rank -> replacement). Group ORDER is
        preserved position-wise, so every comm-relative address — pipeline
        slots, p2p peers, MoE expert indices — is unchanged; only the world
        ranks behind them move. Fresh cids are allocated (the old channels
        span retired ranks and would fault-check forever) and registered
        eagerly so the first post-resize step is scoped to the new group.

        The per-rank shard state moves with the slot: in the thread tier a
        "dead" rank's memory is still addressable (death is a declaration),
        so weights and KV chains survive the move; a process tier would
        re-shard from checkpoint here instead. The shard and KV tensors stay
        where they are on the device: only the dictionary entries move."""
        from ..comm import Comm
        ctx = self.pool.ctx
        self.ranks = tuple(mapping.get(r, r) for r in self.ranks)
        self.wcomm = Comm(self.ranks, ctx.alloc_cid(), ctx=ctx,
                          name="infer-world")
        self.ep_comms = (
            Comm(self.ranks[:self.ep], ctx.alloc_cid(), ctx=ctx,
                 name="infer-ep0"),
            Comm(self.ranks[self.ep:], ctx.alloc_cid(), ctx=ctx,
                 name="infer-ep1"))
        for c in (self.wcomm, *self.ep_comms):
            ctx.channel(c.cid, len(c.group), c.group)
        for old, new in mapping.items():
            if old in self._state:
                self._state[new] = self._state.pop(old)

    # -- admission accounting (scheduler side) -------------------------------
    def kv_demand(self, prompt_len: int, max_new: int) -> int:
        """Blocks one request can touch on each of its home ranks."""
        return self.layers_local * math.ceil((prompt_len + max_new)
                                             / self.block_tokens)

    def can_admit(self, slot: int, need: int) -> bool:
        with self._resv_lock:
            return self._reserved[slot] + need <= self.kv_blocks

    def reserve(self, slot: int, need: int) -> None:
        with self._resv_lock:
            self._reserved[slot] += need

    def unreserve(self, slot: int, need: int) -> None:
        with self._resv_lock:
            self._reserved[slot] = max(0, self._reserved[slot] - need)

    def kv_prefix_acquire(self, rid: int, slot: int,
                          tokens: List[int]) -> int:
        """Adopt the longest registered shared prompt prefix for ``rid``
        on BOTH home ranks of ``slot``; the two caches evict
        independently, so reconcile to the shorter match (truncate keeps
        the plan's ``pos0`` honest on both stages). Returns adopted
        tokens (0 = off/miss)."""
        if not self.prefix_share or len(tokens) < 2:
            return 0
        c0 = self._state[self.ranks[slot]]["kv"]
        c1 = self._state[self.ranks[slot + self.ep]]["kv"]
        h0 = c0.prefix_acquire(rid, tokens)
        h1 = c1.prefix_acquire(rid, tokens)
        h = min(h0, h1)
        if h0 > h:
            c0.truncate(rid, h)
        if h1 > h:
            c1.truncate(rid, h)
        return h

    def memory_bytes(self) -> dict:
        """Device bytes the engine holds on each world rank: its weight
        shards (a tensor shared by several ranks counts on each) and its
        KV pool."""
        out = {}
        for r, st in self._state.items():
            w = sum(t.numel() * t.element_size() for t in st["sp"].values())
            kv = st["kv"]
            out[r] = {"weights": w,
                      "kv": 2 * kv.k.numel() * kv.k.element_size()}
        return out

    def kv_stats(self) -> dict:
        caches = [st["kv"].stats() for st in self._state.values()]
        with self._resv_lock:
            reserved = max(self._reserved) if self._reserved else 0
        return {"blocks_per_rank": self.kv_blocks,
                "block_tokens": self.block_tokens,
                "in_use_max": max(c["in_use"] for c in caches),
                "peak_in_use_max": max(c["peak_in_use"] for c in caches),
                "alloc_failures": sum(c["alloc_failures"] for c in caches),
                "reserved_max": reserved,
                "shared_blocks_max": max(c["shared_blocks"] for c in caches),
                "prefix_entries_max": max(c["prefix_entries"]
                                          for c in caches),
                "prefix_evictions": sum(c["prefix_evictions"]
                                        for c in caches),
                "cow_forks": sum(c["cow_forks"] for c in caches)}

    # -- step execution ------------------------------------------------------
    def run_step(self, plan: StepPlan) -> Dict[int, List[int]]:
        """Execute one plan on every pool rank; returns {rid: accepted
        tokens} (one per prefill, up to spec_k per decode). The per-rank
        closures enqueue under the pool's dispatch lock so engine steps
        interleave atomically with tenant collective ops."""
        results: Dict[int, List[int]] = {}
        errs: list = []
        done = threading.Event()
        remaining = [len(self.ranks)]
        lock = threading.Lock()

        def make(rank):
            def run(_r):
                try:
                    with torch.no_grad():
                        if plan.trace is None:
                            out = self._rank_step(rank, plan)
                        else:
                            from .. import tracectx as _tc
                            with _tc.bind(plan.trace):
                                out = self._rank_step(rank, plan)
                    if out:
                        with lock:
                            results.update(out)
                except BaseException as e:      # noqa: BLE001 - reported below
                    errs.append(e)
                finally:
                    with lock:
                        remaining[0] -= 1
                        if remaining[0] == 0:
                            done.set()
            return run

        with self.pool._dispatch_lock:
            for r in self.ranks:
                self.pool._queues[r].put((None, make(r)))
        if not done.wait(timeout=300.0):
            raise MPIError(f"inference step {plan.seq} timed out on the "
                           f"pool", code=_ec.ERR_OTHER)
        if errs:
            err = errs[0]
            if isinstance(err, MPIError):
                raise err
            raise MPIError(f"inference step failed: {err!r}",
                           code=_ec.ERR_OTHER)
        return results

    def _rank_step(self, rank: int, plan: StepPlan) -> Dict[int, List[int]]:
        st = self._state[rank]
        # speculative rollback: the plan's pos is the authoritative chain
        # length — drop any rows a previous verify pass rejected
        for dc in plan.decodes:
            st["kv"].truncate(dc.rid, dc.pos)
        out = (self._stage0_step(st, plan) if st["stage"] == 0
               else self._stage1_step(st, plan))
        for rid in plan.releases:
            st["kv"].close(rid)
        return out

    # -- shared layer math ---------------------------------------------------
    def _rows(self, n: int) -> torch.Tensor:
        """``n`` zero rows of the model's width on the engine's device."""
        return torch.zeros((n, self.cfg.d_model), dtype=torch.float32,
                           device=self.device)

    def _embed(self, st: dict, tokens) -> torch.Tensor:
        """The embedding rows of ``tokens``, one fresh ``(k, d)`` tensor."""
        emb = st["sp"]["embed"]
        return torch.stack([emb[t] for t in tokens])

    def _attn_row(self, st: dict, rid: int, li: int, x: torch.Tensor,
                  pos: int) -> torch.Tensor:
        """Attention of ONE token row at global position ``pos`` over the
        session's own KV chain (appending this token first). Row-at-a-time
        on purpose: no reduction ever spans co-batched sessions."""
        sp = st["sp"]
        d, h = self.cfg.d_model, self.cfg.n_heads
        dh = self.cfg.head_dim
        cos, sin = self._rope[0][pos], self._rope[1][pos]
        y = _rms_row(x, sp["ln1"][li])
        qkv = y @ sp["w_qkv"][li]
        q = _rope_row(qkv[:d].reshape(h, dh), cos, sin)
        k = _rope_row(qkv[d:2 * d].reshape(h, dh), cos, sin)
        v = qkv[2 * d:].reshape(h, dh)
        st["kv"].append(rid, li, k, v)
        K, V = st["kv"].view(rid, li)                       # (t, h, dh)
        s = torch.einsum("hd,thd->ht", q, K) / float(np.sqrt(np.float32(dh)))
        s = s - s.amax(dim=1, keepdim=True)
        w = torch.exp(s)
        w = w / w.sum(dim=1, keepdim=True)
        o = torch.einsum("ht,thd->hd", w, V).reshape(d)
        return x + o @ sp["w_proj"][li]

    def _moe_rows(self, st: dict, comm, li: int, xs: torch.Tensor,
                  capacity: int) -> torch.Tensor:
        """The MoE FFN half-layer over this rank's ``(k, d)`` rows: gate,
        dispatch to expert ranks, combine, residual. Called by EVERY rank
        of the stage each round (k may be 0) — rank-uniform collectives.
        One call = one batched dispatch + one combine (plus the count
        exchange); ``moe_rounds`` is what rounds/token is measured from.
        The routing comes to the host once a round (the gates' argmax)."""
        from ..parallel.ep import moe_host_dispatch_combine
        if st["slot"] == 0:
            with self._rounds_lock:
                self.moe_rounds += 1
            if perfvars.enabled():
                perfvars.note_infer(moe_rounds=1)
        sp = st["sp"]
        k = xs.shape[0]
        if k:
            ys = torch.stack([_rms_row(x, sp["ln2"][li]) for x in xs])
            gates = torch.stack([_softmax_row(y @ sp["w_gate"][li])
                                 for y in ys])
            pick = gates.argmax(dim=1)
            eidx = pick.cpu().numpy()
            psel = gates.gather(1, pick[:, None])[:, 0]
        else:
            ys = self._rows(0)
            eidx = np.zeros(0, np.int64)
            psel = torch.zeros(0, dtype=torch.float32, device=self.device)
        w_in, w_out = sp["w_in"][li], sp["w_out"][li]

        def expert(rows):
            return _gelu(rows @ w_in) @ w_out

        moe = moe_host_dispatch_combine(ys, eidx, expert, comm,
                                        capacity=capacity)
        return xs + moe * psel[:, None]

    def _sample(self, st: dict, xs: List[torch.Tensor],
                rid: Optional[int] = None) -> List[int]:
        """Greedy next tokens from final hidden rows, one product a row
        (ties -> lowest token id, the first maximum, as np.argmax); the ids
        come to the host in one copy."""
        sp = st["sp"]
        logits = torch.stack([_rms_row(x, sp["ln_f"]) @ sp["embed"].T
                              for x in xs])
        if self.logit_log is not None and rid is not None:
            self.logit_log.setdefault(rid, []).extend(
                logits.float().cpu().numpy())
        return [int(t) for t in logits.argmax(dim=1).tolist()]

    # -- prefill bodies ------------------------------------------------------
    def _writer(self, pf: Prefill, nparts: int, slot: int):
        return PartitionStreamWriter(nparts, self.block_tokens,
                                     self.cfg.d_model, self.ep + slot,
                                     pf.tag, self.wcomm, device=self.device)

    def _reader(self, pf: Prefill, nparts: int, slot: int):
        return PartitionStreamReader(nparts, self.block_tokens,
                                     self.cfg.d_model, slot, pf.tag,
                                     self.wcomm, device=self.device)

    def _prefill_rows0(self, st: dict, plan: StepPlan) -> int:
        """Row-loop baseline (``infer_vectorized`` off): each prefill's
        partitions make their own MoE rounds, one request at a time."""
        B, slot = self.block_tokens, st["slot"]
        L0 = self.layers_local
        serial_ns = 0
        for pf in plan.prefills:
            tlen = len(pf.tokens)
            nparts = math.ceil(tlen / B)
            mine = pf.slot == slot
            writer = self._writer(pf, nparts, slot) if mine else None
            for p in range(nparts):
                lo, hi = p * B, min((p + 1) * B, tlen)
                t0 = time.perf_counter_ns()
                xs = (self._embed(st, pf.tokens[lo:hi]) if mine
                      else self._rows(0))
                for li in range(L0):
                    for j in range(xs.shape[0]):
                        xs[j] = self._attn_row(st, pf.rid, li, xs[j],
                                               pf.pos0 + lo + j)
                    xs = self._moe_rows(st, self.ep_comms[0], li, xs, B)
                if mine:
                    writer.publish(p, xs)
                    serial_ns += time.perf_counter_ns() - t0
            if writer is not None:
                writer.finish()
                if pf.last and pf.register is not None:
                    st["kv"].register_prefix(pf.rid, pf.register)
        return serial_ns

    def _prefill_vec0(self, st: dict, plan: StepPlan) -> int:
        """Vectorized: every prefill advances partition p together — one
        batched dispatch + combine per (round, layer) for the whole
        co-batch, per-peer counts from all requests' rows at once. Each
        request's rows still stream out the moment its own partition is
        computed, so the cross-stage overlap is untouched."""
        B, slot = self.block_tokens, st["slot"]
        L0 = self.layers_local
        serial_ns = 0
        live = []
        for pf in plan.prefills:
            nparts = math.ceil(len(pf.tokens) / B)
            mine = pf.slot == slot
            writer = self._writer(pf, nparts, slot) if mine else None
            live.append((pf, nparts, mine, writer))
        for p in range(max((e[1] for e in live), default=0)):
            active = [e for e in live if p < e[1]]
            segs, cap = [], 0
            for pf, _, mine, _ in active:
                lo, hi = p * B, min((p + 1) * B, len(pf.tokens))
                cap += hi - lo
                xs = (self._embed(st, pf.tokens[lo:hi]) if mine
                      else self._rows(0))
                segs.append([pf, lo, xs])
            t0 = time.perf_counter_ns()
            for li in range(L0):
                for seg in segs:
                    pf, lo, xs = seg
                    for j in range(xs.shape[0]):
                        xs[j] = self._attn_row(st, pf.rid, li, xs[j],
                                               pf.pos0 + lo + j)
                cat = (torch.cat([s[2] for s in segs]) if segs
                       else self._rows(0))
                cat = self._moe_rows(st, self.ep_comms[0], li, cat, cap)
                o = 0
                for seg in segs:
                    n = seg[2].shape[0]
                    seg[2] = cat[o:o + n]
                    o += n
            published = False
            for (pf, _, mine, writer), seg in zip(active, segs):
                if mine:
                    writer.publish(p, seg[2])
                    published = True
            if published:
                serial_ns += time.perf_counter_ns() - t0
        for pf, _, mine, writer in live:
            if writer is not None:
                writer.finish()
                if pf.last and pf.register is not None:
                    st["kv"].register_prefix(pf.rid, pf.register)
        return serial_ns

    def _prefill_rows1(self, st: dict, plan: StepPlan,
                       results: Dict[int, List[int]]) -> int:
        B, slot = self.block_tokens, st["slot"]
        L1 = self.layers_local
        pwait_ns = 0
        for pf in plan.prefills:
            tlen = len(pf.tokens)
            nparts = math.ceil(tlen / B)
            mine = pf.slot == slot
            reader = self._reader(pf, nparts, slot) if mine else None
            last = None
            for p in range(nparts):
                lo, hi = p * B, min((p + 1) * B, tlen)
                xs = (reader.take(p)[:hi - lo].clone() if mine
                      else self._rows(0))
                for li in range(L1):
                    for j in range(xs.shape[0]):
                        xs[j] = self._attn_row(st, pf.rid, li, xs[j],
                                               pf.pos0 + lo + j)
                    xs = self._moe_rows(st, self.ep_comms[1], li, xs, B)
                if mine and hi == tlen:
                    last = xs[-1]
            if reader is not None:
                reader.finish()
                pwait_ns += reader.wait_ns
                if pf.last and pf.register is not None:
                    st["kv"].register_prefix(pf.rid, pf.register)
                if pf.last:
                    results[pf.rid] = self._sample(st, [last], pf.rid)
        return pwait_ns

    def _prefill_vec1(self, st: dict, plan: StepPlan,
                      results: Dict[int, List[int]]) -> int:
        B, slot = self.block_tokens, st["slot"]
        L1 = self.layers_local
        pwait_ns = 0
        live, lasts = [], {}
        for pf in plan.prefills:
            nparts = math.ceil(len(pf.tokens) / B)
            mine = pf.slot == slot
            reader = self._reader(pf, nparts, slot) if mine else None
            live.append((pf, nparts, mine, reader))
        for p in range(max((e[1] for e in live), default=0)):
            active = [e for e in live if p < e[1]]
            segs, cap = [], 0
            for pf, _, mine, reader in active:
                lo, hi = p * B, min((p + 1) * B, len(pf.tokens))
                cap += hi - lo
                xs = (reader.take(p)[:hi - lo].clone() if mine
                      else self._rows(0))
                segs.append([pf, lo, hi, xs])
            for li in range(L1):
                for seg in segs:
                    pf, lo, _, xs = seg
                    for j in range(xs.shape[0]):
                        xs[j] = self._attn_row(st, pf.rid, li, xs[j],
                                               pf.pos0 + lo + j)
                cat = (torch.cat([s[3] for s in segs]) if segs
                       else self._rows(0))
                cat = self._moe_rows(st, self.ep_comms[1], li, cat, cap)
                o = 0
                for seg in segs:
                    n = seg[3].shape[0]
                    seg[3] = cat[o:o + n]
                    o += n
            for (pf, _, mine, _), seg in zip(active, segs):
                if mine and seg[2] == len(pf.tokens):
                    lasts[pf.rid] = seg[3][-1]
        for pf, _, mine, reader in live:
            if reader is not None:
                reader.finish()
                pwait_ns += reader.wait_ns
                if pf.last and pf.register is not None:
                    st["kv"].register_prefix(pf.rid, pf.register)
                if pf.last:
                    results[pf.rid] = self._sample(st, [lasts[pf.rid]],
                                                   pf.rid)
        return pwait_ns

    # -- stage bodies --------------------------------------------------------
    def _decode_cap(self, plan: StepPlan) -> int:
        """Per-expert routing capacity for the decode dispatch — plan-wide
        row total, so no sender can ever overflow it (rank-uniform)."""
        return max(self.max_batch,
                   sum(len(dc.tokens) for dc in plan.decodes))

    def _stage0_step(self, st: dict, plan: StepPlan) -> Dict[int, List[int]]:
        slot = st["slot"]
        L0 = self.layers_local
        serial_ns = (self._prefill_vec0(st, plan) if self.vectorized
                     else self._prefill_rows0(st, plan))
        mine_dec = [dc for dc in plan.decodes if dc.slot == slot]
        rows = [(dc, j) for dc in mine_dec for j in range(len(dc.tokens))]
        xs = (self._embed(st, [t for dc in mine_dec for t in dc.tokens])
              if rows else self._rows(0))
        cap = self._decode_cap(plan)
        for li in range(L0):
            for i, (dc, j) in enumerate(rows):
                xs[i] = self._attn_row(st, dc.rid, li, xs[i], dc.pos + j)
            xs = self._moe_rows(st, self.ep_comms[0], li, xs, cap)
        if rows:
            from .. import pointtopoint as p2p
            p2p.Send(xs.contiguous(), self.ep + slot,
                     DECODE_TAG_BASE + plan.seq % 4096, self.wcomm)
        if serial_ns and perfvars.enabled():
            perfvars.note_infer(stage_serial_ns=serial_ns)
        return {}

    def _stage1_step(self, st: dict, plan: StepPlan) -> Dict[int, List[int]]:
        slot = st["slot"]
        L1 = self.layers_local
        results: Dict[int, List[int]] = {}
        pwait_ns = (self._prefill_vec1(st, plan, results) if self.vectorized
                    else self._prefill_rows1(st, plan, results))
        mine_dec = [dc for dc in plan.decodes if dc.slot == slot]
        rows = [(dc, j) for dc in mine_dec for j in range(len(dc.tokens))]
        xs = self._rows(len(rows))
        if rows:
            from .. import pointtopoint as p2p
            p2p.Recv(xs, slot, DECODE_TAG_BASE + plan.seq % 4096, self.wcomm)
        cap = self._decode_cap(plan)
        for li in range(L1):
            for i, (dc, j) in enumerate(rows):
                xs[i] = self._attn_row(st, dc.rid, li, xs[i], dc.pos + j)
            xs = self._moe_rows(st, self.ep_comms[1], li, xs, cap)
        # speculative acceptance: row i's greedy output is valid iff every
        # drafted token before it matched the greedy output one row
        # earlier — so each accepted token is bitwise the k=1 token
        o = 0
        for dc in mine_dec:
            kk = len(dc.tokens)
            outs = self._sample(st, [xs[o + i] for i in range(kk)], dc.rid)
            m = 1
            while m < kk and dc.tokens[m] == outs[m - 1]:
                m += 1
            results[dc.rid] = outs[:m]
            o += kk
        if pwait_ns and perfvars.enabled():
            perfvars.note_infer(pwait_ns=pwait_ns)
        return results
