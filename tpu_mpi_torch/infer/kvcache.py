"""Paged KV-cache manager + cross-stage partition streaming
(``tpu_mpi_torch.infer``; the port of ``tpu_mpi/infer/kvcache.py``).

Two concerns live here, both per-rank state of the inference engine:

- :class:`PagedKVCache` — attention key/value storage in fixed-size token
  blocks (``TPU_MPI_KV_BLOCK_TOKENS`` wide) drawn from one preallocated
  pool, chained per ``(session, layer)``. Paging is what makes admission a
  counting problem: the scheduler admits a request iff the blocks its
  whole generation can touch are still free, so a full cache turns into
  queueing delay (and eventually a typed SLO eviction) instead of a
  mid-generation failure. Blocks are refcounted: with
  ``TPU_MPI_KV_PREFIX_SHARE`` on, a completed prefill publishes its
  prompt-prefix blocks into a content-hash registry
  (:meth:`~PagedKVCache.register_prefix`) and later sessions presenting
  the same prompt prefix adopt them read-only
  (:meth:`~PagedKVCache.prefix_acquire`) — the first append into a block
  someone else can still see forks a private copy (copy-on-write), so a
  sharer can never observe another tenant's writes. Isolation is a
  property of the admission layer: a session only ever matches prefixes
  of tokens it presented itself, and the KV rows behind a match are a
  pure function of those tokens and the model.
- :class:`PartitionStreamWriter` / :class:`PartitionStreamReader` — the
  prefill activation stream between pipeline stages, built on the MPI-4
  partitioned ops (``Psend_init``/``Pready`` producing,
  ``Precv_init``/``Parrived`` consuming). Stage k marks each block of
  prompt activations ready as it finishes computing it; stage k+1 starts
  attending over block p while block p+1 is still being produced. The
  reader accounts its blocked time (``wait_ns``) so the pvar infer block
  can show the overlap won over a serial stage hand-off.

Port mapping: the K/V pool is one preallocated ``(n_blocks, block_tokens,
n_heads, head_dim)`` tensor pair on a device (``device=``, default
``cuda``; the engine passes its pool's), so a rank's KV lives on the card.
The bookkeeping — block tables, refcounts, the prefix registry with its
hash and token compare, copy-on-write forks — stays on the host, exactly
as in the reference. Rows arrive as tensors (numpy arrays are taken too)
and :meth:`~PagedKVCache.view` returns tensors; the partition streams
carry device tensors through the port's ``Psend_init``/``Precv_init``.
"""

from __future__ import annotations

import hashlib
import math
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..buffers import resolve_device
from ..error import MPIError
from .. import error as _ec
from .. import locksmith


def _prefix_key(tokens: Sequence[int]) -> bytes:
    """Content hash of a token prefix (the registry key). Stored entries
    also keep the token tuple itself and compare it on lookup, so a hash
    collision can never splice one tenant's KV into another's prompt."""
    return hashlib.blake2b(np.asarray(tokens, np.int64).tobytes(),
                           digest_size=16).digest()


class PagedKVCache:
    """Block-paged K/V storage for one rank.

    ``n_blocks`` blocks of ``block_tokens`` tokens, each token a
    ``(n_heads, head_dim)`` K and V row. Chains grow one token at a time
    (:meth:`append`) and are read back as contiguous ``(t, h, dh)`` views
    (:meth:`view`). All methods are thread-safe; the scheduler reads
    :meth:`free_blocks` / :meth:`stats` while rank workers mutate.
    """

    def __init__(self, n_blocks: int, block_tokens: int, n_heads: int,
                 head_dim: int, dtype: torch.dtype = torch.float32,
                 device: Any = None):
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self.device = resolve_device(device)
        self.k = torch.zeros((self.n_blocks, self.block_tokens, int(n_heads),
                              int(head_dim)), dtype=dtype, device=self.device)
        self.v = torch.zeros_like(self.k)
        # pop() from the tail: allocation order is a pure function of the
        # alloc/release history, never of timing
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._chains: Dict[Tuple[int, int], List[int]] = {}
        self._len: Dict[Tuple[int, int], int] = {}
        # content-hash prefix registry (LRU): key -> {"tokens": tuple,
        # "blocks": {layer: [ids]}, "partials": [{"tokens","blocks"}]}.
        # The registry holds one reference per block it can hand out.
        self._registry: "OrderedDict[bytes, dict]" = OrderedDict()
        self._lock = locksmith.make_lock("infer.kvcache")
        self.peak_in_use = 0
        self.alloc_failures = 0
        self.cow_forks = 0
        self.prefix_evictions = 0

    # -- block accounting (lock held) ----------------------------------------
    def _alloc_locked(self) -> int:
        if not self._free:
            self._evict_registry_locked()
        if not self._free:
            self.alloc_failures += 1
            raise MPIError(
                f"KV cache exhausted: {self.n_blocks} blocks all in "
                f"use (raise TPU_MPI_KV_BLOCK_TOKENS pool sizing or "
                f"lower TPU_MPI_INFER_MAX_BATCH)",
                code=_ec.ERR_BUFFER)
        b = self._free.pop()
        self._refs[b] = 1
        in_use = self.n_blocks - len(self._free)
        if in_use > self.peak_in_use:
            self.peak_in_use = in_use
        return b

    def _deref_locked(self, b: int) -> None:
        r = self._refs.get(b, 1) - 1
        if r <= 0:
            self._refs.pop(b, None)
            self._free.append(b)
        else:
            self._refs[b] = r

    def _evict_registry_locked(self) -> None:
        """Drop LRU registry entries until a block actually frees (or the
        registry is empty): the prefix cache yields under pool pressure,
        never the other way around."""
        while self._registry and not self._free:
            _, e = self._registry.popitem(last=False)
            self.prefix_evictions += 1
            for blocks in e["blocks"].values():
                for b in blocks:
                    self._deref_locked(b)
            for ch in e["partials"]:
                for b in ch["blocks"].values():
                    self._deref_locked(b)

    # -- chains ---------------------------------------------------------------
    def _row(self, row: Any) -> torch.Tensor:
        if isinstance(row, torch.Tensor):
            return row
        return torch.as_tensor(np.asarray(row), device=self.device)

    def append(self, sid: int, layer: int, k_row: Any, v_row: Any) -> None:
        """Append one token's ``(h, dh)`` K/V rows to a chain, growing it
        by a fresh block on a block boundary. Appending into a block that
        anyone else can still see (another chain or the prefix registry)
        forks a private copy first — copy-on-write."""
        key = (sid, layer)
        B = self.block_tokens
        with self._lock:
            n = self._len.get(key, 0)
            chain = self._chains.setdefault(key, [])
            if n % B == 0 and n // B == len(chain):
                chain.append(self._alloc_locked())
            bi = n // B
            b = chain[bi]
            if self._refs.get(b, 1) > 1:
                nb = self._alloc_locked()
                self.k[nb] = self.k[b]
                self.v[nb] = self.v[b]
                self._deref_locked(b)
                chain[bi] = nb
                self.cow_forks += 1
                b = nb
            off = n % B
            self.k[b, off] = self._row(k_row)
            self.v[b, off] = self._row(v_row)
            self._len[key] = n + 1

    def view(self, sid: int, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The chain's K and V as dense ``(t, h, dh)`` tensors on the
        cache's device (copies — the caller attends over a stable
        snapshot): one concatenation of the chain's blocks each."""
        key = (sid, layer)
        with self._lock:
            n = self._len.get(key, 0)
            B = self.block_tokens
            chain = list(self._chains.get(key, ()))[:math.ceil(n / B)]
            if not chain:
                empty = self.k.new_empty((0,) + tuple(self.k.shape[2:]))
                return empty, empty.clone()
            out_k = torch.cat([self.k[b] for b in chain])[:n]
            out_v = torch.cat([self.v[b] for b in chain])[:n]
        return out_k, out_v

    def length(self, sid: int, layer: int) -> int:
        with self._lock:
            return self._len.get((sid, layer), 0)

    def truncate(self, sid: int, new_len: int) -> None:
        """Roll every chain of one session back to at most ``new_len``
        tokens (the speculative-decode rejection rollback). Whole blocks
        past the boundary are dereferenced; a surviving tail block that is
        still shared simply stays read-only until the next append forks
        it."""
        B = self.block_tokens
        with self._lock:
            for key in [k for k in self._chains if k[0] == sid]:
                n = self._len.get(key, 0)
                if n <= new_len:
                    continue
                chain = self._chains[key]
                keep = math.ceil(new_len / B)
                for b in reversed(chain[keep:]):
                    self._deref_locked(b)
                del chain[keep:]
                self._len[key] = new_len

    def close(self, sid: int) -> int:
        """Release every chain of one session; returns blocks dropped
        from its chains (shared blocks survive under their remaining
        references)."""
        freed = 0
        with self._lock:
            for key in [k for k in self._chains if k[0] == sid]:
                chain = self._chains.pop(key)
                self._len.pop(key, None)
                for b in reversed(chain):
                    self._deref_locked(b)
                freed += len(chain)
        return freed

    # -- cross-tenant prefix sharing ------------------------------------------
    def register_prefix(self, sid: int, tokens: Sequence[int]) -> None:
        """Publish session ``sid``'s prompt-prefix KV into the registry:
        one entry per full-block boundary (so a later prompt that
        diverges anywhere can still match its longest agreeing boundary),
        each holding its prefix blocks by reference plus a *continuation
        child* — the next block's tokens — for mid-block matches. Full
        blocks are referenced as-is (prefill never writes into a
        completed full block again, so they are immutable); the trailing
        partial block is COPIED so the owner keeps appending into its own
        tail without a fork."""
        toks = tuple(int(t) for t in tokens)
        B = self.block_tokens
        nfull = len(toks) // B
        if nfull == 0:
            return
        with self._lock:
            layers = sorted(k[1] for k in self._chains if k[0] == sid)
            if not layers or any(len(self._chains[(sid, li)]) * B
                                 < len(toks) for li in layers):
                return
            for j in range(1, nfull + 1):
                key = _prefix_key(toks[:j * B])
                e = self._registry.get(key)
                if e is None or e["tokens"] != toks[:j * B]:
                    blocks = {li: list(self._chains[(sid, li)][:j])
                              for li in layers}
                    for bl in blocks.values():
                        for b in bl:
                            self._refs[b] = self._refs.get(b, 1) + 1
                    e = {"tokens": toks[:j * B], "blocks": blocks,
                         "partials": []}
                    self._registry[key] = e
                self._registry.move_to_end(key)
                cont = toks[j * B:min((j + 1) * B, len(toks))]
                if not cont or any(ch["tokens"][:len(cont)] == cont
                                   for ch in e["partials"]
                                   if len(ch["tokens"]) >= len(cont)):
                    continue
                if j < nfull:
                    # continuation is a completed (immutable) full block:
                    # share it by reference
                    pblocks = {}
                    for li in layers:
                        b = self._chains[(sid, li)][j]
                        self._refs[b] = self._refs.get(b, 1) + 1
                        pblocks[li] = b
                else:
                    # trailing partial: the owner still appends into it —
                    # copy, so neither side ever needs a fork for it
                    pblocks = {}
                    try:
                        for li in layers:
                            src = self._chains[(sid, li)][j]
                            nb = self._alloc_locked()
                            self.k[nb] = self.k[src]
                            self.v[nb] = self.v[src]
                            pblocks[li] = nb
                    except MPIError:
                        self.alloc_failures -= 1  # pressure: skip, not fail
                        for b in pblocks.values():
                            self._deref_locked(b)
                        continue
                e["partials"].append({"tokens": cont, "blocks": pblocks})

    def prefix_acquire(self, sid: int, tokens: Sequence[int]) -> int:
        """Adopt the longest registered shared prefix of ``tokens`` as the
        initial chains for session ``sid``, capped at ``len(tokens) - 1``
        (the final prompt token is always recomputed so prefill still
        produces the first sampled hidden state). Returns the adopted
        token count (0 = miss). Adopted blocks are read-only references;
        the first divergent append copy-on-writes."""
        toks = tuple(int(t) for t in tokens)
        cap = len(toks) - 1
        B = self.block_tokens
        with self._lock:
            for j in range(len(toks) // B, 0, -1):
                key = _prefix_key(toks[:j * B])
                e = self._registry.get(key)
                if e is None or e["tokens"] != toks[:j * B]:
                    continue
                base = min(j * B, cap)
                best, best_len = None, 0
                if base == j * B:
                    for ch in e["partials"]:
                        L = 0
                        for a, b in zip(ch["tokens"], toks[j * B:]):
                            if a != b:
                                break
                            L += 1
                        L = min(L, cap - j * B)
                        if L > best_len:
                            best, best_len = ch, L
                adopted = base + best_len
                if adopted <= 0:
                    continue
                nb_full = min(j, math.ceil(adopted / B))
                for li, blocks in e["blocks"].items():
                    chain = list(blocks[:nb_full])
                    for b in chain:
                        self._refs[b] = self._refs.get(b, 1) + 1
                    if best is not None and best_len:
                        pb = best["blocks"][li]
                        self._refs[pb] = self._refs.get(pb, 1) + 1
                        chain.append(pb)
                    self._chains[(sid, li)] = chain
                    self._len[(sid, li)] = adopted
                self._registry.move_to_end(key)
                return adopted
        return 0

    # -- reporting ------------------------------------------------------------
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def stats(self) -> dict:
        with self._lock:
            in_use = self.n_blocks - len(self._free)
            shared = sum(1 for r in self._refs.values() if r > 1)
            return {"blocks": self.n_blocks,
                    "block_tokens": self.block_tokens,
                    "in_use": in_use, "peak_in_use": self.peak_in_use,
                    "chains": len(self._chains),
                    "alloc_failures": self.alloc_failures,
                    "shared_blocks": shared,
                    "prefix_entries": len(self._registry),
                    "prefix_evictions": self.prefix_evictions,
                    "cow_forks": self.cow_forks}


class PartitionStreamWriter:
    """Producer side of the stage k -> k+1 prefill activation stream: a
    partitioned send whose partitions are token blocks. :meth:`publish`
    copies one finished block into the send buffer and ``Pready``s it —
    the partition ships immediately, while later blocks are still being
    computed."""

    def __init__(self, nparts: int, block_tokens: int, width: int,
                 dest: int, tag: int, comm, device: Any = None):
        from .. import pointtopoint as p2p
        self.nparts = int(nparts)
        self.block_tokens = int(block_tokens)
        self.buf = torch.zeros((self.nparts * self.block_tokens, width),
                               dtype=torch.float32,
                               device=resolve_device(device))
        self._req = p2p.Psend_init(self.buf, self.nparts, dest, tag, comm)
        self._req.start()

    def publish(self, p: int, rows: torch.Tensor) -> None:
        o = p * self.block_tokens
        k = rows.shape[0]
        if k:
            self.buf[o:o + k] = rows
        self._req.pready(p)

    def finish(self) -> None:
        self._req.wait()


class PartitionStreamReader:
    """Consumer side: a partitioned receive polled one token block at a
    time. :meth:`take` blocks until partition ``p`` has arrived and
    returns its rows; the time spent blocked accumulates in ``wait_ns`` —
    the overlap evidence (a reader that waits much less than the producer
    computes is consuming behind the producer, not after it)."""

    def __init__(self, nparts: int, block_tokens: int, width: int,
                 src: int, tag: int, comm, device: Any = None):
        from .. import pointtopoint as p2p
        self.nparts = int(nparts)
        self.block_tokens = int(block_tokens)
        self.buf = torch.zeros((self.nparts * self.block_tokens, width),
                               dtype=torch.float32,
                               device=resolve_device(device))
        self._req = p2p.Precv_init(self.buf, self.nparts, src, tag, comm)
        self._req.start()
        self.wait_ns = 0

    def take(self, p: int) -> torch.Tensor:
        t0 = time.perf_counter_ns()
        while not self._req.parrived(p):
            time.sleep(0)
        self.wait_ns += time.perf_counter_ns() - t0
        o = p * self.block_tokens
        return self.buf[o:o + self.block_tokens]

    def finish(self) -> None:
        self._req.wait()
