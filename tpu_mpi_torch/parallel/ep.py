"""Expert parallelism: capacity-bounded token routing over an ``ep`` axis —
the port of ``tpu_mpi/parallel/ep.py``.

Two realizations, as in the JAX package:

- :func:`moe_dispatch_combine` — the in-graph path on stacked tensors
  (static shapes, capacity masking, two ``xla.alltoall``; on a CUDA tensor
  each is one launch of the pairwise all-to-all kernel,
  :mod:`tpu_mpi_torch.kernels.permute`, and the exchange is
  differentiable; on a mesh of several axes ``mesh=`` names the rank dims),
  top-1 with one expert a rank; beside it :func:`moe_topk_dispatch_combine`,
  the fine-grained form: top-k of many experts, several held by each rank,
  weighted combine, and no token dropped (the exchange is padded to the
  largest rank-to-rank count of the call);
- :func:`moe_host_dispatch_combine` — the host-path variant with true
  variable counts over the port's ``Alltoall``/``Alltoallv`` on an ``ep``
  communicator, which visits the algorithm-selection layer on every call.
  It takes numpy rows (the JAX package's route, bitwise as there) or
  tensors on a device (the inference engine's): the routing stays on the
  host, and the rows and the expert stay on the device.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable

import numpy as np
import torch

from .. import perfvars as _pv
from .. import xla
from ..xla.collectives import Layout

# Per-thread persistent count-exchange buffers, keyed by (cid, n): the count
# Alltoall keeps one signature every call, so the auto-arm table can promote
# it (see the JAX package's note).
_count_bufs = threading.local()


def _count_exchange_bufs(cid: int, n: int):
    cache = getattr(_count_bufs, "m", None)
    if cache is None:
        cache = _count_bufs.m = {}
    key = (cid, n)
    if key not in cache:
        cache[key] = (np.zeros(n, np.int64), np.zeros(n, np.int64))
    return cache[key]


def moe_dispatch_combine(tokens: torch.Tensor, expert_idx: torch.Tensor,
                         expert_fn: Callable[[torch.Tensor], torch.Tensor], *,
                         capacity: int, axis: str = "ep",
                         mesh: Layout = None) -> torch.Tensor:
    """Top-1 Mixture-of-Experts dispatch/combine.

    tokens: stacked (n, t, d) local tokens — with ``mesh=``, (*mesh sizes,
    t, d) and the experts along ``axis``; expert_idx: the same leading
    dims and t, the target expert (== rank on ``axis``) per token;
    expert_fn: every rank's expert at once, applied to the stacked received
    tokens (*rank dims, n*capacity, d), so that each rank's expert applies
    to its own row. Tokens over capacity are dropped (returned as exact
    zeros), the static-shape MoE contract. Returns the stacked (*rank dims,
    t, d). Differentiable: both exchanges are ``xla.alltoall``."""
    ranks_shape = tuple(tokens.shape[:-2])
    t, d = tokens.shape[-2:]
    n = (tokens.shape[0] if mesh is None
         else xla.size(mesh, axis))
    p = math.prod(ranks_shape)
    flat = tokens.reshape(p, t, d)
    idx = expert_idx.reshape(p, t).to(torch.int64)
    # position of each token within its expert's capacity window
    onehot = torch.nn.functional.one_hot(idx, n).to(torch.int32)   # (p, t, n)
    pos = torch.cumsum(onehot, dim=1) * onehot                      # 1-based
    slot = pos.sum(dim=2) - 1                                       # (p, t)
    keep = slot < capacity
    clip = slot.clamp(0, capacity - 1)
    ranks = torch.arange(p, device=tokens.device)[:, None].expand(p, t)

    # scatter local tokens into per-expert send buffers (*ranks, n, capacity, d)
    send = tokens.new_zeros((p, n, capacity, d))
    send = send.index_put((ranks, idx, clip),
                          torch.where(keep[..., None], flat, 0.0), accumulate=True)
    send = send.view(ranks_shape + (n, capacity, d))

    recv = xla.alltoall(send, axis=axis, mesh=mesh, split_axis=0, concat_axis=0,
                        tiled=True)
    out = expert_fn(recv.reshape(ranks_shape + (n * capacity, d)))
    back = xla.alltoall(out.reshape(ranks_shape + (n, capacity, d)), axis=axis,
                        mesh=mesh, split_axis=0, concat_axis=0, tiled=True)

    # gather results back to token order
    gathered = back.reshape(p, n, capacity, d)[ranks, idx, clip]
    return torch.where(keep[..., None], gathered, 0.0).view(ranks_shape + (t, d))


class TopkRouting:
    """Where the rows of one top-k call go, worked out once on the card with
    one copy of the per-expert counts to the host: every (token, choice) row
    of every rank, sorted by expert inside each rank, with its slot in the
    padded exchange.

    ``n`` ranks of ``t`` tokens pick ``k`` of ``n_experts`` experts, held
    ``n_experts // n`` to a rank in order (rank r: experts ``r * El`` ..).
    ``capacity``: the largest count from one rank to another, the rows a
    block of the exchange holds; ``slot`` (n, t * k): the row of the
    flattened (n, n * capacity) send buffer of each (token, choice) row;
    ``gather`` (n * t * k,): the rows of the flattened received buffer
    (n, n * capacity) in (receiving rank, its expert, source rank) order;
    ``segments``: the row count of each (receiving rank, expert), in that
    order; ``loads`` (n_experts,) on the host."""

    def __init__(self, expert_idx: torch.Tensor, n_experts: int):
        n, t, k = expert_idx.shape
        if n_experts % n:
            raise ValueError(f"{n_experts} experts do not divide over {n} ranks")
        el = n_experts // n
        dev = expert_idx.device
        idx = expert_idx.reshape(n, t * k).to(torch.int64)
        per = torch.zeros(n, n_experts, dtype=torch.int64, device=dev)
        per.scatter_add_(1, idx, torch.ones_like(idx))          # (src, expert)
        counts = per.cpu()                                       # the one sync
        sd = counts.view(n, n, el).sum(-1)                       # (src, dst)
        self.n, self.t, self.k, self.el = n, t, k, el
        self.loads = counts.sum(0)
        self.capacity = int(sd.max())
        self.routed = n * t * k
        self.segments = counts.view(n, n, el).sum(0).reshape(-1).tolist()
        # slot of each row: its (src, dst) block, then its place among the
        # block's rows in expert order (a stable sort keeps token order)
        order = torch.argsort(idx, dim=1, stable=True)
        dst = idx.gather(1, order) // el
        first = (sd.cumsum(1) - sd).to(dev)                      # block starts
        pos = torch.arange(t * k, device=dev) - first.gather(1, dst)
        slot = torch.empty_like(idx)
        slot.scatter_(1, order, dst * self.capacity + pos)
        self.slot = slot
        # received rows by (dst, expert, src): block (dst, src) holds src's
        # rows for dst, in expert order from its start
        c = counts.view(n, n, el).permute(1, 0, 2)               # (dst, src, e)
        within = c.cumsum(2) - c                                 # offset in block
        base = (torch.arange(n).view(n, 1, 1) * n + torch.arange(n).view(1, n, 1)
                ) * self.capacity + within                       # (dst, src, e)
        base, c = base.permute(0, 2, 1).reshape(-1), c.permute(0, 2, 1).reshape(-1)
        starts = c.cumsum(0) - c
        base, starts, c = (x.to(dev) for x in (base, starts, c))
        rep = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c,
                                      output_size=self.routed)
        self.gather = base[rep] + torch.arange(self.routed, device=dev) - starts[rep]

    @property
    def exchanged_rows(self) -> int:
        """Rows one exchange moves, padding included: n * n blocks of
        ``capacity``."""
        return self.n * self.n * self.capacity


def moe_topk_dispatch_combine(tokens: torch.Tensor, expert_idx: torch.Tensor,
                              weights: torch.Tensor,
                              experts: Callable[[torch.Tensor, list], torch.Tensor], *,
                              routing: TopkRouting, axis: str = "ep") -> torch.Tensor:
    """Top-k Mixture-of-Experts dispatch and weighted combine over the one
    rank dim of stacked tokens, no token dropped.

    tokens: (n, t, d), rank r's own tokens; expert_idx: (n, t, k) the
    experts (global ids) each token picked; weights: (n, t, k) their
    weights (any float dtype, differentiable); ``routing``: the
    :class:`TopkRouting` of these ``expert_idx``, which holds the experts
    ``n_experts // n`` to a rank, in order. Each (token, choice) row goes
    to the rank that holds its expert through one ``xla.alltoall`` padded
    to the largest rank-to-rank count, the experts run there, and a second
    ``xla.alltoall`` brings the results back (the all-to-all kernel on a
    CUDA tensor; both differentiable).

    experts(rows, segments): rows (n * t * k, d), sorted by (rank, expert
    of that rank) with ``segments`` the row count of each, in that order
    (one count a held expert of each rank); returns the experts' outputs
    in the same order. The result, (n, t, d) in the tokens' dtype, is each
    token's outputs weighted and summed in float32. With the span ring on,
    the exchange out is a ``model.moe.dispatch`` span and the way back,
    with the weighted sum, ``model.moe.combine`` (the model step's MoE
    phases)."""
    n, t, d = tokens.shape
    k, r = expert_idx.shape[-1], routing
    ranks = torch.arange(n, device=tokens.device)[:, None]
    s = _pv.span_begin(cpu=False)
    try:
        rows = tokens.unsqueeze(2).expand(n, t, k, d).reshape(n, t * k, d)
        send = tokens.new_zeros((n, n * r.capacity, d)).index_put((ranks, r.slot), rows)
        recv = xla.alltoall(send.view(n, n, r.capacity, d), axis=axis, mesh={axis: n},
                            split_axis=0, concat_axis=0, tiled=True)
        flat = recv.reshape(n * n * r.capacity, d)
        arrived = flat.index_select(0, r.gather)
    finally:
        _pv.span_end("model.moe.dispatch", s)
    out = experts(arrived, r.segments)
    s = _pv.span_begin(cpu=False)
    try:
        done = flat.new_zeros(flat.shape).index_put((r.gather,), out)
        back = xla.alltoall(done.view(n, n, r.capacity, d), axis=axis, mesh={axis: n},
                            split_axis=0, concat_axis=0, tiled=True)
        picked = back.reshape(n, n * r.capacity, d)[ranks, r.slot].view(n, t, k, d)
        mixed = (picked.float() * weights.float().unsqueeze(-1)).sum(2)
        return mixed.to(tokens.dtype)
    finally:
        _pv.span_end("model.moe.combine", s)


def moe_host_dispatch_combine(tokens: Any, expert_idx: np.ndarray,
                              expert_fn: Callable[[Any], Any],
                              comm, *, capacity: int) -> Any:
    """Top-1 MoE dispatch/combine on the host path: rank == expert over an
    ``ep`` communicator, shipped with ``Alltoallv`` (true variable counts).

    tokens: (t, d) float32 local tokens (t may be 0), numpy or a tensor;
    expert_idx: (t,) target rank per token, on the host; expert_fn: this
    rank's expert, applied row-wise to whatever tokens arrive. Tokens
    beyond ``capacity`` per destination are dropped and come back as exact
    zeros. Returns (t, d) of the tokens' kind, bitwise-deterministic for a
    fixed routing. Every call makes one int64 ``Alltoall`` of the counts
    (numpy) and two ``Alltoallv`` (dispatch, combine) of the rows. Every
    rank of ``comm`` passes the same kind of rows.
    """
    if isinstance(tokens, torch.Tensor):
        return _dispatch_combine_tensor(tokens, expert_idx, expert_fn, comm,
                                        capacity)
    from .. import collective as _c
    tokens = np.ascontiguousarray(tokens)
    if tokens.ndim != 2:
        tokens = tokens.reshape(-1, tokens.shape[-1] if tokens.size else 1)
    t, d = tokens.shape
    n = comm.size()
    idx = np.asarray(expert_idx, dtype=np.int64).reshape(-1)

    scounts, order = _routing(idx, n, capacity)
    send = tokens[order] if t else tokens.reshape(0, d)

    sbuf, rbuf = _count_exchange_bufs(comm.cid, n)
    sbuf[:] = scounts
    rbuf[:] = 0
    _c.Alltoall(sbuf, rbuf, 1, comm)
    rcounts = [int(c) for c in rbuf]
    sc_el = [c * d for c in scounts]
    rc_el = [c * d for c in rcounts]

    flat_in = np.zeros(sum(rc_el), tokens.dtype)
    _c.Alltoallv(np.ascontiguousarray(send.reshape(-1)), flat_in,
                 sc_el, rc_el, comm)
    arrived = flat_in.reshape(-1, d)

    # the expert one row at a time, so a token's result never depends on
    # how many others shared its exchange
    out = np.empty_like(arrived)
    for i in range(arrived.shape[0]):
        out[i] = expert_fn(arrived[i:i + 1])[0]

    flat_back = np.zeros(sum(sc_el), tokens.dtype)
    _c.Alltoallv(np.ascontiguousarray(out.reshape(-1)), flat_back,
                 rc_el, sc_el, comm)
    combined = np.zeros((t, d), tokens.dtype)   # dropped rows: exact zeros
    if order.size:
        combined[order] = flat_back.reshape(-1, d)
    return combined


def _routing(idx: np.ndarray, n: int, capacity: int):
    """The sender side's routing on the host: per destination, the first
    ``capacity`` of its tokens in token order (routing decides the drop
    set, not arrival jitter): ``(send counts, token order)``."""
    picked = [np.flatnonzero(idx == e)[:capacity] for e in range(n)]
    scounts = [int(p.size) for p in picked]
    order = (np.concatenate(picked) if picked else
             np.zeros(0, np.int64)).astype(np.int64)
    return scounts, order


def _dispatch_combine_tensor(tokens: torch.Tensor, expert_idx: np.ndarray,
                             expert_fn: Callable[[torch.Tensor], torch.Tensor],
                             comm, capacity: int) -> torch.Tensor:
    """The tensor route of :func:`moe_host_dispatch_combine`: the same
    routing and count exchange on the host, the rows moved by the two
    ``Alltoallv`` as tensors on their device, the expert applied there one
    row at a time."""
    from .. import collective as _c
    dev = tokens.device
    tokens = tokens.reshape(-1, tokens.shape[-1]).contiguous()
    t, d = tokens.shape
    n = comm.size()
    idx = np.asarray(expert_idx, dtype=np.int64).reshape(-1)
    scounts, order = _routing(idx, n, capacity)
    order_t = torch.from_numpy(order).to(dev)
    send = tokens.index_select(0, order_t)

    sbuf, rbuf = _count_exchange_bufs(comm.cid, n)
    sbuf[:] = scounts
    rbuf[:] = 0
    _c.Alltoall(sbuf, rbuf, 1, comm)
    rcounts = [int(c) for c in rbuf]
    sc_el = [c * d for c in scounts]
    rc_el = [c * d for c in rcounts]

    flat_in = tokens.new_zeros(sum(rc_el))
    _c.Alltoallv(send.reshape(-1), flat_in, sc_el, rc_el, comm)
    arrived = flat_in.view(-1, d)
    # the expert one row at a time: a row's result never depends on how
    # many others shared its exchange (a product's kernel, and so its
    # summation order, may change with the row count)
    out = torch.empty_like(arrived)
    for i in range(arrived.shape[0]):
        out[i] = expert_fn(arrived[i:i + 1])[0]

    flat_back = tokens.new_zeros(sum(sc_el))
    _c.Alltoallv(out.reshape(-1), flat_back, rc_el, sc_el, comm)
    combined = tokens.new_zeros((t, d))         # dropped rows: exact zeros
    if order.size:
        combined.index_copy_(0, order_t, flat_back.view(-1, d))
    return combined
