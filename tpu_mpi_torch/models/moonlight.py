"""Moonlight-16B-A3B's block (DeepSeek-V3's), trained with expert
parallelism on an in-graph ``ep`` mesh.

Per layer, pre-norm (RMSNorm, eps ``cfg.eps``) around two blocks, each
added to the residual stream:

- multi-head latent attention (MLA): ``q = y W_q`` cut per head into
  ``qk_nope`` + ``qk_rope`` columns; ``[c; k_r] = y W_kva``;
  ``c = RMSNorm(c) g_kv``; ``[k_n; v] = c W_kvb`` per head; rotary
  embeddings (half-split, base ``cfg.rope_base``) on ``q_r`` and on the
  one ``k_r`` all heads share; causal softmax of ``[q_n; q_r].[k_n; k_r]``
  over ``sqrt(qk_nope + qk_rope)`` times ``v``, the heads' outputs
  concatenated times ``W_o``. On a CUDA tensor one ring-attention launch
  (:func:`tpu_mpi_torch.parallel.ring.attend_along`, the sm90 kernel at a
  q/k head dim of 192 beside a v head dim of 128) serves every rank's heads;
- the first ``n_dense`` layers a SwiGLU FFN ``W_down(silu(W_gate y) *
  W_up y)`` of width ``d_ff``; the others a mixture of experts: sigmoid
  scores ``s = sigmoid(y W_r)`` in float32, the top ``top_k`` of
  ``s + b`` chosen (``b`` the selection bias, used for the choice alone;
  ties to the lower expert), weights ``routed_scale * s_i / sum s_chosen``,
  the weighted sum of the chosen SwiGLU experts (width ``d_expert``) plus a
  shared SwiGLU of width ``n_shared * d_expert``.

Then a final RMSNorm, an untied head and the mean next-token
cross-entropy, computed in chunks of ``loss_rows`` tokens so that a step's
float32 logits never exist at once.

Parameters are a flat dictionary by name (:func:`moonlight_shapes`). In the
train step (:func:`moonlight_train_step`) each ``ep`` rank holds its own
sequences and every weight but the routed experts, as a per-rank autograd
leaf (a stride-0 view) whose gradients are summed over ``ep`` by the fold
kernel; rank r holds experts ``r * E / n ..`` of every MoE layer, the
router spans all of them, and the routed rows travel to the experts' ranks
and back through :func:`tpu_mpi_torch.parallel.ep.moe_topk_dispatch_combine`
(the pairwise all-to-all kernel on the card), none dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F

from .. import perfvars as _pv
from ..parallel.ep import TopkRouting, moe_topk_dispatch_combine
from ..parallel.ring import attend_along
from .transformer import (_dense_init, _embed, _leaf, _matmul, _place, _pmean,
                          _psum, _rms_norm, _rope, _unplace)


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    """Moonlight-16B-A3B's sizes (its ``config.json``), with ``n_layers``
    and the rest free to be cut for tests."""
    vocab: int = 163840
    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 27
    n_dense: int = 1            # first_k_dense_replace
    d_ff: int = 11264           # intermediate_size, the dense layers' width
    kv_rank: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    n_experts: int = 64
    top_k: int = 6
    d_expert: int = 1408        # moe_intermediate_size
    n_shared: int = 2
    routed_scale: float = 2.446
    rope_base: float = 50000.0
    eps: float = 1e-5           # rms_norm_eps
    loss_rows: int = 4096       # tokens per chunk of the head and loss
    dtype: torch.dtype = torch.bfloat16

    @property
    def qk_head(self) -> int:
        return self.qk_nope + self.qk_rope


def moonlight_shapes(cfg: MoonlightConfig) -> list:
    """(name, shape, scale) of every weight in forward order; a scale of
    None is a norm's ones, ``"bias"`` the router's selection bias."""
    d, h, L = cfg.d_model, cfg.n_heads, cfg.n_layers
    E, f, fs = cfg.n_experts, cfg.d_expert, cfg.n_shared * cfg.d_expert
    deep = (2 * L) ** -0.5
    out = [("embed", (cfg.vocab, d), 1.0)]
    for i in range(L):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), None),
                (p + "w_q", (d, h * cfg.qk_head), d ** -0.5),
                (p + "w_kva", (d, cfg.kv_rank + cfg.qk_rope), d ** -0.5),
                (p + "ln_kv", (cfg.kv_rank,), None),
                (p + "w_kvb", (cfg.kv_rank, h * (cfg.qk_nope + cfg.v_head)),
                 cfg.kv_rank ** -0.5),
                (p + "w_o", (h * cfg.v_head, d), (h * cfg.v_head) ** -0.5 * deep),
                (p + "ln2", (d,), None)]
        if i < cfg.n_dense:
            out += [(p + "w_gate", (d, cfg.d_ff), d ** -0.5),
                    (p + "w_up", (d, cfg.d_ff), d ** -0.5),
                    (p + "w_down", (cfg.d_ff, d), cfg.d_ff ** -0.5 * deep)]
        else:
            out += [(p + "w_router", (d, E), d ** -0.5),
                    (p + "bias", (E,), "bias"),
                    (p + "e_gate", (E, d, f), d ** -0.5),
                    (p + "e_up", (E, d, f), d ** -0.5),
                    (p + "e_down", (E, f, d), f ** -0.5 * deep),
                    (p + "s_gate", (d, fs), d ** -0.5),
                    (p + "s_up", (d, fs), d ** -0.5),
                    (p + "s_down", (fs, d), fs ** -0.5 * deep)]
    out += [("ln_f", (d,), None), ("head", (d, cfg.vocab), d ** -0.5)]
    return out


BIAS_SCALE = 0.01       # the selection bias: normal(0, 1) times this
LATENT_EPS = 1e-6       # the latent's norm: HF's kv_a_layernorm keeps its default


def moonlight_init(generator: torch.Generator, cfg: MoonlightConfig,
                   device: Any = None) -> dict:
    """Random weights by name (:func:`moonlight_shapes`), in ``cfg.dtype`` on
    ``device`` (default ``cuda``); the selection bias is float32."""
    dense, ones = _dense_init(generator, cfg, device)
    out = {}
    for name, shape, scale in moonlight_shapes(cfg):
        if scale is None:
            out[name] = ones(shape)
        elif scale == "bias":
            out[name] = dense(shape, BIAS_SCALE).float()
        else:
            out[name] = dense(shape, scale)
    return out


def is_expert(name: str) -> bool:
    """A routed expert's weight: held by its rank, its gradient not summed."""
    return name.rsplit(".", 1)[-1] in ("e_gate", "e_up", "e_down")


def is_bias(name: str) -> bool:
    """The selection bias: no gradient and no update."""
    return name.endswith(".bias")


# ---------------------------------------------------------------------------
# Forward on stacked ranks (n, b, t, d)
# ---------------------------------------------------------------------------

def _swiglu(y: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    return _matmul(F.silu(_matmul(y, gate)) * _matmul(y, up), down)


def _mla(cfg: MoonlightConfig, w: Mapping, p: str, x: torch.Tensor,
         positions: torch.Tensor) -> torch.Tensor:
    """x plus latent attention over each rank's own sequences: x (n, b, t, d),
    every rank's heads in one attention call."""
    s = _pv.span_begin(cpu=False)
    try:
        h = cfg.n_heads
        y = _rms_norm(x, w[p + "ln1"], cfg.eps)
        q = _matmul(y, w[p + "w_q"]).unflatten(-1, (h, cfg.qk_head)).transpose(-3, -2)
        c, k_r = _matmul(y, w[p + "w_kva"]).split([cfg.kv_rank, cfg.qk_rope], -1)
        c = _rms_norm(c, w[p + "ln_kv"], LATENT_EPS)
        kv = _matmul(c, w[p + "w_kvb"]).unflatten(-1, (h, cfg.qk_nope + cfg.v_head))
        k_n, v = kv.transpose(-3, -2).split([cfg.qk_nope, cfg.v_head], -1)
        q_n, q_r = q.split([cfg.qk_nope, cfg.qk_rope], -1)
        q = torch.cat([q_n, _rope(q_r, positions, cfg.rope_base)], -1)
        k_r = _rope(k_r.unsqueeze(-3), positions, cfg.rope_base)       # (n, b, 1, t, r)
        k = torch.cat([k_n, k_r.expand(k_r.shape[:-3] + (h,) + k_r.shape[-2:])], -1)
        # the ranks' sequences are their own: a ring of one over all of them
        o = attend_along(q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0), 0,
                         causal=True)[0]
        return x + _matmul(o.transpose(-3, -2).flatten(-2), w[p + "w_o"])
    finally:
        _pv.span_end("model.mla", s)


def route(scores: torch.Tensor, bias: torch.Tensor, k: int, scale: float) -> tuple:
    """The experts each row picks and their weights: the top k of
    ``scores + bias`` (a stable descending sort: of equal values the lower
    expert first), weighted by ``scale * s_i / sum s_chosen`` of the float32
    sigmoid ``scores`` (the bias takes no part). Returns (idx, weights)."""
    order = torch.sort(scores.detach() + bias.float(), dim=-1, descending=True,
                       stable=True).indices
    idx = order[..., :k]
    picked = scores.gather(-1, idx)
    return idx, picked / (picked.sum(-1, keepdim=True) + 1e-20) * scale


def _experts(w: Mapping, p: str) -> Callable:
    """The routed experts of layer ``p`` over rows sorted by expert (global
    order: rank, then its experts), one SwiGLU a segment."""
    gate, up, down = (w[p + k].flatten(0, 1).unbind(0) for k in ("e_gate", "e_up", "e_down"))

    def run(rows: torch.Tensor, segments: list) -> torch.Tensor:
        s = _pv.span_begin(cpu=False)
        try:
            # one split, whose backward is one cat (a slice's would write a
            # whole zero gradient of the rows for each expert)
            outs = [torch.mm(F.silu(x @ gate[e]) * (x @ up[e]), down[e])
                    for e, x in enumerate(rows.split(segments)) if x.shape[0]]
            return torch.cat(outs)
        finally:
            _pv.span_end("model.moe.experts", s)
    return run


def _moe(cfg: MoonlightConfig, w: Mapping, bias: torch.Tensor, p: str,
         y: torch.Tensor) -> torch.Tensor:
    """The routed experts and the shared one of y (n, b, t, d)."""
    n, d = y.shape[0], y.shape[-1]
    tokens = y.reshape(n, -1, d)
    s = _pv.span_begin(cpu=False)
    try:
        scores = torch.sigmoid(_matmul(tokens.float(), w[p + "w_router"].float()))
        idx, weights = route(scores, bias, cfg.top_k, cfg.routed_scale)
        routing = TopkRouting(idx, cfg.n_experts)
    finally:
        _pv.span_end("model.moe.route", s)
    if _pv.enabled():
        _pv.note_model(moe_layers=1, moe_routed_rows=routing.routed,
                       moe_exchanged_rows=2 * routing.exchanged_rows,
                       moe_exchanged_bytes=2 * routing.exchanged_rows * d * y.element_size(),
                       moe_rows_max=int(routing.loads.max()),
                       moe_expert_slots=cfg.n_experts)
    out = moe_topk_dispatch_combine(tokens, idx, weights, _experts(w, p), routing=routing)
    shared = _swiglu(tokens, w[p + "s_gate"], w[p + "s_up"], w[p + "s_down"])
    out = (out + shared).view(y.shape)
    if s is not None and y.requires_grad:
        _backward_span(out, y)
    return out


def _backward_span(out: torch.Tensor, y: torch.Tensor) -> None:
    """The MoE block's backward as a ``model.moe.backward`` span, on the
    thread that runs it: opened when the gradient of its output ``out``
    arrives and closed when that of its input ``y`` is whole, which waits
    on every node of the block and on nothing else (the residual's other
    branch goes on only after ``y``)."""
    held = []
    out.register_hook(lambda g: held.append(_pv.span_begin(cpu=False)))
    y.register_hook(lambda g: _pv.span_end("model.moe.backward", held.pop())
                    if held else None)


def _hidden(cfg: MoonlightConfig, w: Mapping, biases: Mapping,
            tokens: torch.Tensor) -> torch.Tensor:
    """The final-normed hidden rows (n, b, t, d) of stacked tokens (n, b, t)."""
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    x = _embed(w["embed"], tokens)
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        x = _mla(cfg, w, p, x, positions)
        y = _rms_norm(x, w[p + "ln2"], cfg.eps)
        if i < cfg.n_dense:
            x = x + _swiglu(y, w[p + "w_gate"], w[p + "w_up"], w[p + "w_down"])
        else:
            x = x + _moe(cfg, w, biases[p + "bias"], p, y)
    return _rms_norm(x, w["ln_f"], cfg.eps)


def moonlight_forward(cfg: MoonlightConfig, params: Mapping,
                      tokens: torch.Tensor) -> torch.Tensor:
    """float32 logits (b, t, V) of tokens (b, t) under ``params`` as
    :func:`moonlight_init` gives them, on one rank (every expert held
    here). Holds the whole logits: for small sizes."""
    w = {k: (v.unsqueeze(0) if not is_bias(k) else v) for k, v in params.items()}
    hid = _hidden(cfg, w, params, tokens.unsqueeze(0))[0]
    return _matmul(hid, params["head"]).to(torch.float32)


# ---------------------------------------------------------------------------
# Head and loss in chunks
# ---------------------------------------------------------------------------

class _ChunkedXent(torch.autograd.Function):
    """Every rank's mean next-token cross-entropy (n,) of final rows
    y (n, T, d) under its head w (n, d, V), ``rows`` tokens at a time: a
    chunk's logits are its rows times the head in the weights' dtype, their
    log-softmax taken in float32; the loss and the gradients of y and w are
    taken from them at once (softmax less the one-hot, over T, rounded to
    the weights' dtype), so no chunk's logits outlive it. The backward
    scales the gradients by the losses' cotangent."""

    @staticmethod
    def forward(ctx, y, w, labels, rows):
        n, T, _ = y.shape
        losses = torch.empty(n, dtype=torch.float32, device=y.device)
        dy, dw = torch.empty_like(y), torch.empty(w.shape, dtype=w.dtype, device=w.device)
        for r in range(n):
            total = torch.zeros((), dtype=torch.float32, device=y.device)
            for lo in range(0, T, rows):
                yc, lab = y[r, lo:lo + rows], labels[r, lo:lo + rows, None]
                logp = torch.log_softmax(yc @ w[r], -1, dtype=torch.float32)   # (c, V)
                total -= logp.gather(-1, lab).sum()
                p = logp.exp_()
                p.scatter_add_(-1, lab, torch.full(lab.shape, -1.0, device=p.device))
                g = torch.mul(p, 1.0 / T, out=torch.empty(p.shape, dtype=y.dtype,
                                                          device=p.device))
                del logp, p
                torch.mm(g, w[r].t(), out=dy[r, lo:lo + rows])
                if lo == 0:
                    torch.mm(yc.t(), g, out=dw[r])
                else:
                    dw[r].addmm_(yc.t(), g)
            losses[r] = total / T
        ctx.save_for_backward(dy, dw)
        return losses

    @staticmethod
    def backward(ctx, g):
        dy, dw = ctx.saved_tensors
        scale = g.view(-1, 1, 1)
        return dy.mul_(scale), dw.mul_(scale), None, None


def chunked_xent(y: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """Every rank's mean cross-entropy (n,) of final rows y (n, T, d) under
    its head w (n, d, V) against labels (n, T), ``rows`` tokens a chunk
    (see :class:`_ChunkedXent`)."""
    return _ChunkedXent.apply(y, w, labels.long(), int(rows))


# ---------------------------------------------------------------------------
# The ep train step
# ---------------------------------------------------------------------------

def moonlight_train_step(cfg: MoonlightConfig, mesh, lr: float = 1e-2, *,
                         ep_axis: str = "ep"):
    """Build the SGD train step over the one-axis mesh ``{ep_axis: n}``.

    Returns ``step(params, tokens, labels) -> (params, loss)`` with params
    as :func:`moonlight_init` gives them and tokens/labels the global
    (batch, seq) integer tensors, rank r holding sequences
    ``r * batch / n ..``. Each rank's loss is the mean over its own tokens;
    the step differentiates their sum: the replicated weights' per-rank
    gradients are summed over ``ep`` (one fold-kernel launch a tensor),
    the routed experts' stay with the rank that holds them, and the update
    is ``(p - lr * g).to(p.dtype)``; the selection bias is left as it is.
    The loss returned is the ranks' mean.

    Timed into the ``perfvars`` model block as the flagship's step is
    (``steps``, ``step_ns`` and its four phases) and, per MoE layer,
    ``moe_layers``, ``moe_routed_rows``, ``moe_exchanged_rows`` and
    ``moe_exchanged_bytes`` (the forward's two exchanges, padding
    included), ``moe_rows_max`` (the busiest expert's rows) and
    ``moe_expert_slots`` (experts a layer). With the span ring on, each MoE
    layer's backward is a ``model.moe.backward`` span."""
    if tuple(mesh.axis_names) != (ep_axis,):
        raise ValueError(f"the Moonlight step takes the one-axis mesh {{{ep_axis!r}: n}}, "
                         f"got axes {tuple(mesh.axis_names)}")
    n = mesh.axis_size(ep_axis)
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not divide over {n} ep ranks")
    layout = {ep_axis: n}
    el = cfg.n_experts // n

    def step(params, tokens, labels):
        b_all, t = tokens.shape
        if b_all % n:
            raise ValueError(f"batch {b_all} does not split over {n} ep ranks")
        ph = _pv.Phases("model.step")
        try:
            own = {}
            for name, p in params.items():
                if is_expert(name):
                    own[name] = _leaf(p.view((n, el) + tuple(p.shape[1:])))
                elif not is_bias(name):
                    own[name] = _leaf(_place(p, [], layout))
            hid = _hidden(cfg, own, params, tokens.view(n, b_all // n, t))
            losses = chunked_xent(hid.reshape(n, -1, cfg.d_model), own["head"],
                                  labels.reshape(n, -1), cfg.loss_rows)
            del hid
            ph.lap("model.forward")
            grads = list(torch.autograd.grad(losses.sum(), list(own.values())))
            ph.lap("model.backward")
            summed = {}
            for i, name in enumerate(own):
                g, grads[i] = grads[i], None
                if is_expert(name):
                    summed[name] = g.reshape(params[name].shape)
                else:
                    summed[name] = _unplace(_psum(g, ep_axis, layout), [], layout)
                del g
            ph.lap("model.grad_sum")
            loss = _pmean(losses.detach(), ep_axis, layout)[0]
            new = {k: (p - lr * summed.pop(k)).to(p.dtype) if k in summed else p
                   for k, p in params.items()}
            ph.lap("model.update")
        finally:
            step_ns = ph.close()
        if _pv.enabled():
            ns = ph.ns
            _pv.note_model(steps=1, step_ns=step_ns, forward_ns=ns["model.forward"],
                           backward_ns=ns["model.backward"],
                           grad_sum_ns=ns["model.grad_sum"], update_ns=ns["model.update"])
        return new, loss

    return step
