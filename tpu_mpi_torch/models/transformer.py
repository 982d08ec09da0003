"""Flagship model: a GPT-style transformer trained with DP x TP x SP, and
its pipelined MoE (DP x PP x EP) and 4-axis (DP x TP x SP x PP) variants
— the port of ``tpu_mpi/models/transformer.py``.

Pre-norm attention + FFN layers with RoPE by global position. Attention
heads and FFN hidden units shard over a ``tp`` axis (Megatron
column/row-parallel with the f/g pair, :mod:`tpu_mpi_torch.parallel.tp`),
the sequence over an ``sp`` axis with exact ring attention
(:mod:`tpu_mpi_torch.parallel.ring`, the ring-attention kernel on a CUDA
tensor), the batch over a ``dp`` axis, layers over a ``pp`` axis (GPipe,
:mod:`tpu_mpi_torch.parallel.pp`, the permute kernel) and experts over an
``ep`` axis (:mod:`tpu_mpi_torch.parallel.ep`, the all-to-all kernel).

The ranks of a mesh share one card and per-rank tensors are stacked, one
leading rank dim per mesh axis (:mod:`tpu_mpi_torch.xla.mesh`), with one
exception: what is the same on every tp rank (the residual stream, the
norms, the embedding) is held once, without a tp dim, and a tp-sharded
tensor puts its tp dim in front of the other rank dims. Inside a train
step every parameter becomes a per-rank leaf of autograd, a stride-0 view
over the ranks it is replicated on, so that each rank's gradient comes
back on its own, and each leaf's gradient is reduced as the JAX step
reduces it, one fold-kernel launch per reduction (per psum) for all its
groups at once. The step differentiates the sum of every rank's loss, the
seed ``value_and_grad`` gives each rank, through the collectives'
transposes (a psum's is a psum, a permute's the inverse permute, an
all-to-all's the swapped one): the arithmetic of the JAX step bodies run
under ``shard_map(..., check_vma=False)`` (ROADMAP Queue C).

Parameters are plain dictionaries of tensors shaped as the JAX package's
pytrees (``layers`` a list of per-layer dictionaries in the flat model;
one layer-stacked tensor per name in the pipelined ones), so
:func:`params_from_jax` carries a JAX model's weights across unchanged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import perfvars as _pv
from .. import xla
from ..buffers import resolve_device
from ..operators import SUM
from ..parallel import dp as _dp
from ..parallel.ep import moe_dispatch_combine
from ..parallel.pp import pipeline_forward
from ..parallel.ring import attend_along
from ..parallel.tp import _per_rank_matmul, column_parallel, row_parallel


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_seq: int = 512
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _dense_init(generator: torch.Generator, cfg: TransformerConfig, device: Any):
    """``dense(shape, scale)`` and ``ones(shape)`` on ``device`` (default
    ``cuda``): normal(0, 1) * scale in float32, drawn from ``generator`` on
    its own device, cast to ``cfg.dtype``. A seeded CPU generator gives the
    same weights on every ``device``; raises when CUDA is asked for and
    absent."""
    dev = resolve_device(device)

    def dense(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * scale).to(device=dev, dtype=cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return dense, ones


def transformer_init(generator: torch.Generator, cfg: TransformerConfig,
                     device: Any = None) -> dict:
    """Random weights with the JAX package's shapes and scales (norm scales
    are ones), on ``device`` (default ``cuda``; see :func:`_dense_init`)."""
    dense, ones = _dense_init(generator, cfg, device)
    d, f = cfg.d_model, cfg.d_ff
    params = {"embed": dense((cfg.vocab, d), d ** -0.5), "ln_f": ones(d),
              "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": ones(d),
            "w_qkv": dense((d, 3 * d), d ** -0.5),
            "w_proj": dense((d, d), (2 * d * cfg.n_layers) ** -0.5),
            "ln2": ones(d),
            "w_in": dense((d, f), d ** -0.5),
            "w_out": dense((f, d), (2 * f * cfg.n_layers) ** -0.5),
        })
    return params


def transformer_param_specs(cfg: TransformerConfig, tp_axis: Optional[str]) -> dict:
    """The partition of every parameter, as the JAX package's
    ``PartitionSpec`` pytree: a tuple naming the mesh axis each dim is cut
    over (``(None, tp)`` column-sharded, ``(tp, None)`` row-sharded, ``()``
    replicated)."""
    col, row, rep = (None, tp_axis), (tp_axis, None), ()
    return {
        "embed": rep,
        "ln_f": rep,
        "layers": [{
            "ln1": rep, "w_qkv": col, "w_proj": row,
            "ln2": rep, "w_in": col, "w_out": row,
        } for _ in range(cfg.n_layers)],
    }


def shard_params(params: dict, cfg: TransformerConfig, n: int,
                 tp_axis: str = "tp") -> dict:
    """The tp shards of ``params`` for n ranks, stacked tp rank dim first:
    a column-sharded (..., d, c) weight becomes (n, ..., d, c/n) with rank
    r's contiguous columns (``w_qkv`` is packed per head, so a shard holds
    whole heads), a row-sharded (..., k, d) weight (n, ..., k/n, d);
    replicated parameters stay as they are. Takes the flat model's
    parameters (:func:`transformer_init`) or the 4-axis model's
    layer-stacked ones (:func:`transformer_4d_init`)."""
    def cut(x: torch.Tensor, spec: tuple) -> torch.Tensor:
        for dim, name in enumerate(spec):
            if name == tp_axis:
                if x.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of size {x.shape[dim]} "
                                     f"does not split over {n} ranks")
                return x.unflatten(dim, (n, -1)).movedim(dim, 0).contiguous()
        return x

    if "layers" not in params:
        specs = transformer_4d_specs("pp", tp_axis)
        return {k: cut(v, specs[k]) for k, v in params.items()}
    specs = transformer_param_specs(cfg, tp_axis)
    return {
        "embed": cut(params["embed"], specs["embed"]),
        "ln_f": cut(params["ln_f"], specs["ln_f"]),
        "layers": [{k: cut(v, spec[k]) for k, v in layer.items()}
                   for layer, spec in zip(params["layers"], specs["layers"])],
    }


def params_from_jax(params_np: Mapping[str, Any], cfg: TransformerConfig,
                    device: Any) -> dict:
    """The JAX model's parameter pytree, as numpy arrays, as the port's
    dictionary of ``cfg.dtype`` tensors on ``device``: the flat model's
    (``layers`` a list of dictionaries) or a layer-stacked one (the
    pipelined MoE's or the 4-axis model's). Float32 and bfloat16 arrays
    carry across exactly (via float32)."""
    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=cfg.dtype)

    if "layers" not in params_np:
        return {k: conv(v) for k, v in params_np.items()}
    return {
        "embed": conv(params_np["embed"]),
        "ln_f": conv(params_np["ln_f"]),
        "layers": [{k: conv(v) for k, v in layer.items()}
                   for layer in params_np["layers"]],
    }


# ---------------------------------------------------------------------------
# Per-rank layouts
# ---------------------------------------------------------------------------

def _place(x: torch.Tensor, named: Sequence[str], layout: Mapping[str, int]) -> torch.Tensor:
    """x's leading dims, one per axis in ``named``, as the leading rank dims
    of ``layout`` in its order; an axis of the layout that x lacks is a
    stride-0 replica."""
    named = list(named)
    for a in layout:
        if a not in named:
            x = x.unsqueeze(len(named))
            named.append(a)
    k = len(named)
    x = x.permute([named.index(a) for a in layout] + list(range(k, x.dim())))
    return x.expand(tuple(layout.values()) + tuple(x.shape[k:]))


def _unplace(x: torch.Tensor, named: Sequence[str], layout: Mapping[str, int]) -> torch.Tensor:
    """The inverse of :func:`_place` for a tensor the same on every replica:
    rank 0 of each axis not in ``named``, the others in ``named`` order."""
    order = list(layout)
    for a in reversed(order):
        if a not in named:
            x = x.select(order.index(a), 0)
            order.remove(a)
    return x.permute([order.index(a) for a in named] + list(range(len(order), x.dim())))


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().requires_grad_()


def _per_rank_scale(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A norm scale for x: held once (d,), or per rank (*R, d) and viewed
    to broadcast over x's (*R, ..., d)."""
    lead = scale.dim() - 1
    return scale.view(tuple(scale.shape[:lead]) + (1,) * (x.dim() - lead - 1)
                      + (scale.shape[-1],))


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a weight held once (d_in, d_out), or each rank's x times
    its own w for a weight with leading rank dims (*R, d_in, d_out)."""
    return x @ w if w.dim() == 2 else _per_rank_matmul(x, w)


def _embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding for tokens; an embedding with leading rank
    dims (*R, V, d) looks each rank's tokens (*R, ...) up in its own copy."""
    if embed.dim() == 2:
        return embed[tokens]
    ranks = tuple(embed.shape[:-2])
    p = int(np.prod(ranks))
    flat = tokens.reshape((p, -1))
    rows = torch.arange(p, device=tokens.device)[:, None]
    out = embed.reshape((p,) + tuple(embed.shape[-2:]))[rows, flat]
    return out.view(tuple(tokens.shape) + (embed.shape[-1],))


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * _per_rank_scale(scale, x)


def _rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings of x (..., t, dh) at frequencies ``base ** (-i /
    half)``; ``positions`` (broadcasting to x's (..., t)) are *global*, so
    sequence shards agree."""
    half = x.shape[-1] // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(base, exps)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., t, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _sp_positions(n: int, t: int, device: Any, after: int = 0) -> torch.Tensor:
    """Global positions of n stacked sequence blocks of t, to broadcast
    over q (..., n, [after rank dims], b, h, t, dh)."""
    ranks = torch.arange(n, device=device)[:, None]
    return (ranks * t + torch.arange(t, device=device)).view(
        (n,) + (1,) * (after + 2) + (t,))


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of logits (..., V) against labels."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -ll.mean()


def _xent_ranked(logits: torch.Tensor, labels: torch.Tensor, ranks: int) -> torch.Tensor:
    """Every rank's own mean cross-entropy, (*R,) for logits (*R, b, t, V)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -ll.flatten(ranks).mean(-1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _tp_size(cfg: TransformerConfig, params: dict) -> int:
    """The tp ranks of ``params``: the leading dim of a sharded ``w_qkv``
    (the flat model's first layer's, or the layer-stacked one), 1 when the
    weights are not sharded."""
    w = params["layers"][0]["w_qkv"] if "layers" in params else params["w_qkv"]
    whole = 2 if "layers" in params else 3
    n = w.shape[0] if w.dim() > whole else 1
    if cfg.n_heads % n:
        raise ValueError(f"n_heads={cfg.n_heads} must be divisible by tp size {n}")
    return n


def transformer_forward(cfg: TransformerConfig, params: dict,
                        tokens: torch.Tensor, *, tp_axis: Optional[str] = None,
                        sp_axis: Optional[str] = None) -> torch.Tensor:
    """Logits (float32) for a token block.

    - both axes None: tokens (b, t) int, params from
      :func:`transformer_init`; returns (b, t, V).
    - ``sp_axis``: tokens stacked (..., n, b, t_local), rank r of the sp dim
      holding global positions ``r*t_local ..`` (leading dims, e.g. dp
      ranks, ride along); returns the stacked (..., n, b, t_local, V).
    - ``tp_axis``: params from :func:`shard_params`; tokens held once as
      above; returns the logits stacked over the tp ranks in front, every
      rank's the same (one tensor, viewed n times): (n, b, t, V), or with
      ``sp_axis`` too (n_tp, ..., n_sp, b, t_local, V)."""
    t = tokens.shape[-1]
    sp_dim = tokens.dim() - 3 if sp_axis is not None else None
    if sp_dim is not None:
        positions = _sp_positions(tokens.shape[sp_dim], t, tokens.device)
    else:
        positions = torch.arange(t, device=tokens.device)
    s = _pv.span_begin()
    try:
        logits = _logits(cfg, params, tokens, positions, tp_axis=tp_axis,
                         sp_axis=sp_axis, sp_dim=sp_dim or 0)
    finally:
        _pv.span_end("model.forward", s)
    if tp_axis is None:
        return logits
    n = _tp_size(cfg, params)
    return logits.unsqueeze(0).expand((n,) + tuple(logits.shape))


def _logits(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor, *, tp_axis: Optional[str],
            sp_axis: Optional[str], sp_dim: int = 0) -> torch.Tensor:
    """The forward at its native layout: held once over tp, stacked over
    the other rank dims of the tokens (and for per-rank params, each rank
    with its own)."""
    x = _embed(params["embed"], tokens)
    for layer in params["layers"]:
        s = _pv.span_begin(cpu=False)
        try:
            x = _attn_ffn_block(cfg, layer, x, positions, tp_axis=tp_axis,
                                sp_axis=sp_axis, sp_dim=sp_dim)
        finally:
            _pv.span_end("model.block", s)
    x = _rms_norm(x, params["ln_f"])
    return _matmul(x, params["embed"].transpose(-1, -2)).to(torch.float32)


def _attention(cfg: TransformerConfig, ln: torch.Tensor, w_qkv: torch.Tensor,
               w_proj: torch.Tensor, x: torch.Tensor, positions: torch.Tensor, *,
               tp_axis: Optional[str], sp_axis: Optional[str],
               sp_dim: int = 0) -> torch.Tensor:
    """x plus pre-norm causal attention: ring attention along the rank dim
    ``sp_dim`` of x under ``sp_axis``, dense otherwise; heads sharded over
    the tp ranks under ``tp_axis``."""
    b, t, _ = x.shape[-3:]
    dh = cfg.head_dim
    y = _rms_norm(x, ln)
    if tp_axis is not None:
        qkv = column_parallel(y, w_qkv, axis=tp_axis)             # (n, ..., 3d/n)
    else:
        qkv = _matmul(y, w_qkv)                                   # (..., b, t, 3d)
    lead = tuple(qkv.shape[:-3])
    L = len(lead)
    h_local = qkv.shape[-1] // (3 * dh)
    # w_qkv columns are packed per head ([head][q|k|v][dh]), so a
    # contiguous tp column shard holds whole heads
    qkv = qkv.reshape(lead + (b, t, h_local, 3, dh)).transpose(L + 1, L + 2)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]  # (..., b, h, t, dh)
    q = _rope(q, positions)
    k = _rope(k, positions)
    if sp_axis is not None:
        o = attend_along(q, k, v, sp_dim + (tp_axis is not None), causal=True)
    else:
        s = torch.matmul(q * dh ** -0.5, k.transpose(-1, -2))
        mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~mask, -1e30)
        o = torch.matmul(torch.softmax(s, dim=-1), v)
    o = o.transpose(L + 1, L + 2).reshape(lead + (b, t, h_local * dh))
    if tp_axis is not None:
        return x + row_parallel(o, w_proj, axis=tp_axis)
    return x + _matmul(o, w_proj)


def _attn_ffn_block(cfg: TransformerConfig, layer: dict, x: torch.Tensor,
                    positions: torch.Tensor, *, tp_axis: Optional[str],
                    sp_axis: Optional[str], sp_dim: int = 0) -> torch.Tensor:
    """One transformer layer (pre-norm attention + FFN) on x (..., b, t, d):
    held once over tp (the heads and FFN units per rank in between), with
    leading rank dims under sp (the sp dim at ``sp_dim``). A layer's
    weights may be stacked per rank (tp dim first) to take per-rank
    gradients."""
    x = _attention(cfg, layer["ln1"], layer["w_qkv"], layer["w_proj"], x,
                   positions, tp_axis=tp_axis, sp_axis=sp_axis, sp_dim=sp_dim)
    # -- feed-forward (jax.nn.gelu's default is the tanh approximation) --
    y = _rms_norm(x, layer["ln2"])
    if tp_axis is not None:
        hmid = F.gelu(column_parallel(y, layer["w_in"], axis=tp_axis),
                      approximate="tanh")
        return x + row_parallel(hmid, layer["w_out"], axis=tp_axis)
    hmid = F.gelu(_matmul(y, layer["w_in"]), approximate="tanh")
    return x + _matmul(hmid, layer["w_out"])


# ---------------------------------------------------------------------------
# The DP x TP x SP train step
# ---------------------------------------------------------------------------

def _sizes(mesh, names: Sequence[str]) -> dict:
    """``{axis: size}`` of the named axes, 1 for an axis the mesh lacks."""
    return {a: (mesh.axis_size(a) if a in mesh.axis_names else 1) for a in names}


def _sgd(params: Any, grads: list, lr: float) -> Any:
    new = [(p - lr * g).to(p.dtype) for p, g in zip(_dp.leaves(params), grads)]
    return _dp.unflatten(params, new)


def _psum(x: torch.Tensor, axes, layout: Mapping[str, int]) -> torch.Tensor:
    """``lax.psum(x, axes)`` of a stacked x whose leading rank dims are the
    layout's."""
    return xla.allreduce(x, SUM, axis=axes, mesh=layout)


def _pmean(x: torch.Tensor, axes, layout: Mapping[str, int]) -> torch.Tensor:
    return _psum(x, axes, layout) / xla.size(layout, axes)


def _layout(tree: Any) -> tuple:
    """The structure of a tree of tensors, with each leaf's shape, dtype,
    strides and device in its place."""
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree),) + tuple(_layout(v) for v in tree)
    return tuple(tree.shape), tree.dtype, tree.stride(), tree.device


def _step_signature(params: Any, tokens: torch.Tensor, labels: torch.Tensor) -> tuple:
    """What a train step's launches depend on beyond the mesh and lr it
    closes over: the layout of its inputs."""
    return _layout((params, tokens, labels))


class _StepGraph:
    """A train step's body as one CUDA graph. The first call for an input
    signature runs ``eager`` (the warm-up a capture needs), the second
    captures ``body`` on static copies of the inputs and every later one
    replays it; a new signature's capture drops the old graph. A call
    copies its inputs in and returns copies of the outputs, so no tensor a
    caller passes or keeps is written. The body calls the module's
    functions as an eager step does, so one patched before the capture is
    captured with it. The kernel table counts the wrappers' launches, which
    the capture makes once; a replay adds nothing there and one to the
    model block's ``graph_replays``."""

    def __init__(self, body, eager):
        self.body, self.eager = body, eager
        self.warm = self.sig = self.graph = None

    def __call__(self, params, tokens, labels):
        t0 = time.perf_counter_ns()
        sig = _step_signature(params, tokens, labels)
        if sig == self.sig:
            return self._run(params, tokens, labels, t0, captures=0)
        if sig != self.warm:
            self.warm = sig
            return self.eager(params, tokens, labels)
        # the old graph's pool goes before the new one fills
        self.sig = self.graph = self.new = self.ins = self.outs = None
        src = _dp.leaves(params) + [tokens, labels]
        ins = [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
               for x in src]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            new, loss = self.body(_dp.unflatten(params, ins[:-2]), ins[-2], ins[-1],
                                  lambda phase: None)
        self.new, self.ins, self.outs = new, ins, _dp.leaves(new) + [loss]
        self.copy_bytes = sum(x.numel() * x.element_size() for x in ins + self.outs)
        self.sig, self.graph = sig, graph
        return self._run(params, tokens, labels, t0, captures=1)

    def _run(self, params, tokens, labels, t0: int, captures: int):
        torch._foreach_copy_(self.ins, _dp.leaves(params) + [tokens, labels])
        self.graph.replay()
        outs = [torch.empty_like(x) for x in self.outs]
        torch._foreach_copy_(outs, self.outs)
        if _pv.enabled():
            _pv.note_model(steps=1, step_ns=time.perf_counter_ns() - t0,
                           graph_captures=captures, graph_replays=1,
                           graph_copy_bytes=self.copy_bytes)
        return _dp.unflatten(self.new, outs[:-1]), outs[-1]


def transformer_train_step(cfg: TransformerConfig, mesh, lr: float = 1e-2, *,
                           dp_axis: str = "dp", tp_axis: str = "tp",
                           sp_axis: str = "sp"):
    """Build the SGD train step over ``mesh``: batch over ``dp_axis``,
    heads and FFN units over ``tp_axis`` and the sequence over ``sp_axis``
    (an axis the mesh lacks has size 1).

    Returns (step, param_specs): ``step(params, tokens, labels) -> (params,
    loss)`` with tokens/labels the global (batch, seq) integer tensors and
    params tp-sharded by :func:`shard_params` when the mesh has the tp axis,
    as :func:`transformer_init` gives them otherwise. As in the JAX step,
    each (dp, sp) rank's loss is the mean over its own tokens, their
    gradients are summed over (dp, sp) (the fused fold kernel, one launch
    per parameter tensor for all tp ranks), tp gradients come out whole
    from the f/g pair, the update is ``(p - lr * g).to(p.dtype)`` and the
    loss is the (dp, sp) ranks' mean.

    Each eager step is timed into the ``perfvars`` model block (``steps``,
    ``step_ns`` and the four phases that tile it: ``forward_ns`` the
    placement, logits and loss, ``backward_ns`` the autograd pass,
    ``grad_sum_ns`` the gradient folds, ``update_ns`` the loss mean and the
    SGD update), and with the span ring on recorded as ``model.step`` over
    ``model.<phase>`` spans.

    On CUDA inputs the step is one CUDA graph (:class:`_StepGraph`): the
    first call for an input signature runs eagerly, the second captures the
    body and every later one replays it. A captured or replayed step adds
    ``steps``, ``step_ns`` (the host's copies and replay), ``graph_replays``
    and ``graph_copy_bytes`` to the model block, and a capture
    ``graph_captures``; the phases advance on eager steps alone. The kernel
    table counts the launches its wrappers make, an eager step's and the
    capture's; a replay adds none there. CPU tensors always run eagerly."""
    specs = transformer_param_specs(cfg, tp_axis)
    names = (dp_axis, tp_axis, sp_axis)
    if len(set(names)) != 3:
        raise ValueError(f"dp, tp and sp axes {names} name one axis twice")
    if not any(a in mesh.axis_names for a in names):
        raise ValueError(f"mesh axes {mesh.axis_names} name none of {names}")
    held = _sizes(mesh, (dp_axis, sp_axis))          # held once over tp
    n_dp, n_sp = held.values()
    n_tp = _sizes(mesh, (tp_axis,))[tp_axis]
    sharded_layout = {tp_axis: n_tp, **held}
    data = (dp_axis, sp_axis)
    sharded = tp_axis in mesh.axis_names

    def body(params, tokens, labels, lap):
        b, t = tokens.shape

        def cut(x):             # (b, t) -> (n_dp, n_sp, b/n_dp, t/n_sp)
            return x.view(n_dp, b // n_dp, n_sp, t // n_sp).transpose(1, 2)

        def ranked(p, spec):
            if sharded and tp_axis in spec:
                return _leaf(_place(p, [tp_axis], sharded_layout))
            return _leaf(_place(p, [], held))

        own = _dp.tree_map(ranked, params, specs)
        cut_over_tp = _dp.leaves(_dp.tree_map(lambda p, s: sharded and tp_axis in s,
                                              params, specs))
        positions = _sp_positions(n_sp, t // n_sp, tokens.device)
        logits = _logits(cfg, own, cut(tokens), positions,
                         tp_axis=tp_axis if sharded else None,
                         sp_axis=sp_axis if n_sp > 1 else None, sp_dim=1)
        losses = _xent_ranked(logits, cut(labels), 2)             # (n_dp, n_sp)
        lap("model.forward")
        grads = torch.autograd.grad(losses.sum(), _dp.leaves(own))
        lap("model.backward")
        summed = []
        for g, over_tp in zip(grads, cut_over_tp):
            if over_tp:
                summed.append(_unplace(_psum(g, data, sharded_layout), [tp_axis],
                                       sharded_layout))
            else:
                summed.append(_unplace(_psum(g, data, held), [], held))
        lap("model.grad_sum")
        loss = _pmean(losses.detach(), data, held)[0, 0]
        new = _sgd(params, summed, lr)
        lap("model.update")
        return new, loss

    def eager(params, tokens, labels):
        ph = _pv.Phases("model.step")
        try:
            new, loss = body(params, tokens, labels, ph.lap)
        finally:
            step_ns = ph.close()
        if _pv.enabled():
            ns = ph.ns
            _pv.note_model(steps=1, step_ns=step_ns,
                           forward_ns=ns["model.forward"],
                           backward_ns=ns["model.backward"],
                           grad_sum_ns=ns["model.grad_sum"],
                           update_ns=ns["model.update"])
        return new, loss

    graph = _StepGraph(body, eager)

    def step(params, tokens, labels):
        if _tp_size(cfg, params) != (n_tp if sharded else 1):
            raise ValueError(f"params are cut for {_tp_size(cfg, params)} tp "
                             f"ranks, the mesh has {n_tp}")
        b, t = tokens.shape
        if b % n_dp or t % n_sp:
            raise ValueError(f"batch {b} x sequence {t} does not split over "
                             f"{n_dp} dp x {n_sp} sp ranks")
        if tokens.device.type == "cuda":
            return graph(params, tokens, labels)
        return eager(params, tokens, labels)

    return step, specs


# ---------------------------------------------------------------------------
# Pipeline x expert-parallel variant (DP x PP x EP)
# ---------------------------------------------------------------------------

_STAGE_KEYS = ("ln1", "w_qkv", "w_proj", "ln2", "w_gate", "w_in", "w_out")


def transformer_pp_moe_init(generator: torch.Generator, cfg: TransformerConfig,
                            n_experts: int, device: Any = None) -> dict:
    """Layer-stacked params for the pipelined MoE transformer: every layer
    tensor carries a leading (n_layers,) dim (sharded over 'pp'); the expert
    FFN weights add an (n_experts,) dim (sharded over 'ep'). On ``device``
    (default ``cuda``; see :func:`_dense_init`)."""
    dense, ones = _dense_init(generator, cfg, device)
    d, f, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, n_experts
    return {
        "embed": dense((cfg.vocab, d), d ** -0.5),
        "ln_f": ones((d,)),
        "ln1": ones((L, d)),
        "w_qkv": dense((L, d, 3 * d), d ** -0.5),
        "w_proj": dense((L, d, d), (2 * d * L) ** -0.5),
        "ln2": ones((L, d)),
        "w_gate": dense((L, d, E), d ** -0.5),
        "w_in": dense((L, E, d, f), d ** -0.5),
        "w_out": dense((L, E, f, d), (2 * f * L) ** -0.5),
    }


def transformer_pp_moe_specs(pp_axis: str, ep_axis: str) -> dict:
    """The partition of every parameter of :func:`transformer_pp_moe_init`,
    as the JAX package's ``PartitionSpec`` pytree (tuples of axis names)."""
    lyr = (pp_axis,)
    return {
        "embed": (), "ln_f": (),
        "ln1": lyr, "w_qkv": lyr, "w_proj": lyr, "ln2": lyr, "w_gate": lyr,
        "w_in": (pp_axis, ep_axis), "w_out": (pp_axis, ep_axis),
    }


def transformer_pp_moe_host_params(params: dict, cfg: TransformerConfig,
                                   n_experts: int, stage: int, n_stages: int,
                                   expert: int, device: Any = None) -> dict:
    """Numpy float32 slice of one (pipeline stage, expert) shard of
    :func:`transformer_pp_moe_init` params (tensors or arrays), for a
    host-path inference engine: the stage's slab of layer tensors plus
    only this rank's expert FFN weights (w_in/w_out lose their expert
    dim). ``embed``/``ln_f`` ride along on every rank — stage 0 embeds,
    the last stage computes logits. With ``device``, the same slices as
    contiguous float32 tensors on that device instead (the port's
    inference engine; params already there are sliced in place)."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} must divide over "
                         f"{n_stages} pipeline stages")
    if not 0 <= expert < n_experts:
        raise ValueError(f"expert {expert} out of range [0, {n_experts})")
    per = cfg.n_layers // n_stages
    lo, hi = stage * per, (stage + 1) * per

    def host(a):
        if device is not None:
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.asarray(a, dtype=np.float32))
            return a.detach().to(device=device,
                                 dtype=torch.float32).contiguous()
        if isinstance(a, torch.Tensor):
            a = a.detach().to(device="cpu", dtype=torch.float32).numpy()
        return np.ascontiguousarray(np.asarray(a, dtype=np.float32))

    out = {"embed": host(params["embed"]), "ln_f": host(params["ln_f"])}
    for k in ("ln1", "w_qkv", "w_proj", "ln2", "w_gate"):
        out[k] = host(params[k][lo:hi])
    for k in ("w_in", "w_out"):
        out[k] = host(params[k][lo:hi, expert])
    return out


def _pp_moe_stage(cfg: TransformerConfig, ep_axis: str, capacity: int,
                  layout: Mapping[str, int], stage: dict, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """One pipeline stage on every rank at once: x (*R, b, t, d) with R the
    layout's rank dims; each local layer a causal dense attention plus a
    top-1 MoE FFN routed over ``ep_axis``. ``stage`` holds per-rank leaves
    (*R, L_local, ...)."""
    k = len(layout)
    lead = tuple(x.shape[:-3])
    b, t, d = x.shape[-3:]
    for i in range(stage["w_qkv"].shape[k]):
        layer = {key: w.select(k, i) for key, w in stage.items()}
        # -- attention (heads local: this config spends its ranks on pp/ep)
        x = _attention(cfg, layer["ln1"], layer["w_qkv"], layer["w_proj"], x,
                       positions, tp_axis=None, sp_axis=None)
        # -- MoE FFN: each token to its argmax expert over ep, scaled by the
        # selected gate probability (Switch-style), as the JAX stage
        y = _rms_norm(x, layer["ln2"]).reshape(lead + (b * t, d))
        gate = torch.softmax(_matmul(y, layer["w_gate"]), dim=-1)
        eidx = torch.argmax(gate, dim=-1)
        p_sel = gate.gather(-1, eidx[..., None])
        w_in, w_out = layer["w_in"].select(k, 0), layer["w_out"].select(k, 0)

        def expert(tok, w_in=w_in, w_out=w_out):
            return _matmul(F.gelu(_matmul(tok, w_in), approximate="tanh"), w_out)

        out = moe_dispatch_combine(y, eidx, expert, capacity=capacity,
                                   axis=ep_axis, mesh=layout)
        x = x + (out * p_sel).reshape(lead + (b, t, d))
    return x


def _check_pipeline(cfg: TransformerConfig, sizes: dict, pp_axis: str,
                    microbatches: Optional[int]) -> int:
    if cfg.n_layers % sizes[pp_axis]:
        raise ValueError(f"n_layers={cfg.n_layers} must divide over "
                         f"{sizes[pp_axis]} pipeline stages")
    return microbatches or max(2, 2 * sizes[pp_axis])


def _last_stage_loss(logits, labels, layout, pp_axis) -> torch.Tensor:
    """``lax.psum(where(last stage, l, 0), pp)`` of every rank's loss."""
    k = len(layout)
    l = _xent_ranked(logits, labels, k)
    pp_dim, n_pp = tuple(layout).index(pp_axis), layout[pp_axis]
    last = (torch.arange(n_pp, device=l.device) == n_pp - 1).view(
        (n_pp,) + (1,) * (k - pp_dim - 1))
    return _psum(torch.where(last, l, torch.zeros_like(l)), pp_axis, layout)


def transformer_pp_moe_train_step(cfg: TransformerConfig, mesh, n_experts: int,
                                  lr: float = 1e-2, *, dp_axis: str = "dp",
                                  pp_axis: str = "pp", ep_axis: str = "ep",
                                  microbatches: Optional[int] = None):
    """The SGD step of DP x PP x EP: batch sharded over ``dp_axis``, layers
    over ``pp_axis`` (GPipe microbatch rotation, the permute kernel), expert
    FFNs over ``ep_axis`` (padded all-to-all routing, the all-to-all
    kernel). ``n_experts`` must equal the ep axis size.

    Returns (step, param_specs); ``step(params, tokens, labels) -> (params,
    loss)`` with params as :func:`transformer_pp_moe_init` gives them and
    tokens/labels the global (batch, seq) integer tensors. Each leaf's
    gradient is reduced as the JAX step reduces it
    (``tpu_mpi/models/transformer.py:400-412``): experts ``psum(g, dp) /
    n_ep``, ``embed``/``ln_f`` ``pmean(psum(g, (dp, pp)), ep)``, the other
    layer tensors ``pmean(psum(g, dp), ep)``; the loss is
    ``pmean(pmean(loss, dp), ep)``."""
    sizes = _sizes(mesh, mesh.axis_names)
    for a in (dp_axis, pp_axis, ep_axis):
        if a not in sizes:
            raise ValueError(f"mesh is missing axis {a!r}")
    if n_experts != sizes[ep_axis]:
        raise ValueError(f"n_experts={n_experts} must equal the {ep_axis!r} "
                         f"axis size {sizes[ep_axis]}")
    n_dp, n_pp, n_ep = sizes[dp_axis], sizes[pp_axis], sizes[ep_axis]
    m = _check_pipeline(cfg, sizes, pp_axis, microbatches)
    specs = transformer_pp_moe_specs(pp_axis, ep_axis)
    L_local = cfg.n_layers // n_pp

    def leaf(name, p):
        if name in ("embed", "ln_f"):
            return _place(p, [], sizes)
        slab = p.unflatten(0, (n_pp, L_local))                  # (n_pp, L_l, ...)
        if name in ("w_in", "w_out"):                           # (n_pp, n_ep, L_l, 1, ...)
            slab = slab.unflatten(2, (n_ep, 1)).movedim(2, 1)
            return _place(slab, [pp_axis, ep_axis], sizes)
        return _place(slab, [pp_axis], sizes)

    def unleaf(name, g):
        if name in ("embed", "ln_f"):
            return _unplace(g, [], sizes)
        if name in ("w_in", "w_out"):
            g = _unplace(g, [pp_axis, ep_axis], sizes).movedim(1, 2)
            return g.flatten(2, 3).flatten(0, 1)
        return _unplace(g, [pp_axis], sizes).flatten(0, 1)

    def reduce_leaf(name, g):
        if name in ("w_in", "w_out"):
            return _psum(g, dp_axis, sizes) / n_ep
        if name in ("embed", "ln_f"):
            return _pmean(_psum(g, (dp_axis, pp_axis), sizes), ep_axis, sizes)
        return _pmean(_psum(g, dp_axis, sizes), ep_axis, sizes)

    def step(params, tokens, labels):
        b_all, t = tokens.shape
        if b_all % n_dp:
            raise ValueError(f"batch {b_all} does not split over {n_dp} dp ranks")
        b = b_all // n_dp
        if b % m:
            raise ValueError(f"local batch {b} must divide into {m} microbatches")
        capacity = max(1, 2 * (b // m) * t // n_experts)
        positions = torch.arange(t, device=tokens.device)
        toks = _place(tokens.view(n_dp, b, t), [dp_axis], sizes)
        labs = _place(labels.view(n_dp, b, t), [dp_axis], sizes)
        own = {k: _leaf(leaf(k, p)) for k, p in params.items()}
        stage = {k: own[k] for k in _STAGE_KEYS}
        lead = tuple(sizes.values())
        e = _embed(own["embed"], toks).reshape(lead + (m, b // m, t, cfg.d_model))

        def stage_fn(sp_, x):
            return _pp_moe_stage(cfg, ep_axis, capacity, sizes, sp_, x, positions)

        acts = pipeline_forward(stage_fn, stage, e, axis=pp_axis, mesh=sizes)
        acts = acts.reshape(lead + (b, t, cfg.d_model))
        logits = _matmul(_rms_norm(acts, own["ln_f"]),
                         own["embed"].transpose(-1, -2)).to(torch.float32)
        loss = _last_stage_loss(logits, labs, sizes, pp_axis)
        grads = torch.autograd.grad(loss.sum(), list(own.values()))
        new = {}
        for (k, p), g in zip(params.items(), grads):
            g = unleaf(k, reduce_leaf(k, g))
            new[k] = (p - lr * g).to(p.dtype)
        loss = _pmean(_pmean(loss.detach(), dp_axis, sizes), ep_axis, sizes)
        return new, loss.reshape(-1)[0]

    return step, specs


# ---------------------------------------------------------------------------
# 4-axis variant: DP x TP x SP x PP in one step
# ---------------------------------------------------------------------------

_4D_STAGE_KEYS = ("ln1", "w_qkv", "w_proj", "ln2", "w_in", "w_out")


def transformer_4d_init(generator: torch.Generator, cfg: TransformerConfig,
                        device: Any = None) -> dict:
    """Layer-stacked dense params: every layer tensor carries a leading
    (n_layers,) dim (sharded over 'pp'); within a layer the shapes match
    :func:`transformer_init`'s per-layer dictionaries. On ``device``
    (default ``cuda``; see :func:`_dense_init`)."""
    dense, ones = _dense_init(generator, cfg, device)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    return {
        "embed": dense((cfg.vocab, d), d ** -0.5),
        "ln_f": ones((d,)),
        "ln1": ones((L, d)),
        "w_qkv": dense((L, d, 3 * d), d ** -0.5),
        "w_proj": dense((L, d, d), (2 * d * L) ** -0.5),
        "ln2": ones((L, d)),
        "w_in": dense((L, d, f), d ** -0.5),
        "w_out": dense((L, f, d), (2 * f * L) ** -0.5),
    }


def transformer_4d_specs(pp_axis: str, tp_axis: str) -> dict:
    """The partition of every parameter of :func:`transformer_4d_init`:
    leading layer dim over pp; Megatron column/row sharding over tp within
    each layer (tuples of axis names, as the JAX ``PartitionSpec``s)."""
    return {
        "embed": (), "ln_f": (),
        "ln1": (pp_axis,), "ln2": (pp_axis,),
        "w_qkv": (pp_axis, None, tp_axis),     # column-parallel
        "w_proj": (pp_axis, tp_axis, None),    # row-parallel
        "w_in": (pp_axis, None, tp_axis),
        "w_out": (pp_axis, tp_axis, None),
    }


def transformer_4d_train_step(cfg: TransformerConfig, mesh, lr: float = 1e-2, *,
                              dp_axis: str = "dp", tp_axis: str = "tp",
                              sp_axis: str = "sp", pp_axis: str = "pp",
                              microbatches: Optional[int] = None):
    """The SGD step of DP x TP x SP x PP (the flagship on a 4-axis mesh):
    batch over dp, Megatron f/g matmuls over tp, ring attention over sp,
    GPipe stages over pp.

    Returns (step, param_specs); ``step(params, tokens, labels) -> (params,
    loss)`` with params from :func:`transformer_4d_init` cut by
    :func:`shard_params` (tp-sharded tensors (n_tp, L, ...)) and
    tokens/labels the global (batch, seq) integer tensors. As the JAX step
    (``tpu_mpi/models/transformer.py:525-533``): ``embed``/``ln_f``
    gradients are summed over (dp, sp, pp), the layer stacks' over (dp, sp),
    tp gradients come out whole from f/g, and the loss is the (dp, sp)
    mean of the last stage's."""
    sizes = _sizes(mesh, mesh.axis_names)
    for a in (dp_axis, tp_axis, sp_axis, pp_axis):
        if a not in sizes:
            raise ValueError(f"mesh is missing axis {a!r}")
    n_tp, n_sp, n_pp, n_dp = (sizes[a] for a in (tp_axis, sp_axis, pp_axis, dp_axis))
    if cfg.n_heads % n_tp:
        raise ValueError(f"n_heads={cfg.n_heads} must divide over tp size {n_tp}")
    m = _check_pipeline(cfg, sizes, pp_axis, microbatches)
    specs = transformer_4d_specs(pp_axis, tp_axis)
    held = {a: s for a, s in sizes.items() if a != tp_axis}     # held once over tp
    cut_layout = {tp_axis: n_tp, **held}
    sp_dim = tuple(held).index(sp_axis)
    L_local = cfg.n_layers // n_pp
    k = len(held)

    def tp_cut(name):
        return tp_axis in specs[name]

    def leaf(name, p):
        if name in ("embed", "ln_f"):
            return _place(p, [], held)
        if tp_cut(name):        # (n_tp, L, ...) -> (n_tp, n_pp, L_l, ...)
            return _place(p.unflatten(1, (n_pp, L_local)), [tp_axis, pp_axis],
                          cut_layout)
        return _place(p.unflatten(0, (n_pp, L_local)), [pp_axis], held)

    def unleaf(name, g):
        if name in ("embed", "ln_f"):
            return _unplace(g, [], held)
        if tp_cut(name):
            return _unplace(g, [tp_axis, pp_axis], cut_layout).flatten(1, 2)
        return _unplace(g, [pp_axis], held).flatten(0, 1)

    def step(params, tokens, labels):
        if _tp_size(cfg, params) != n_tp:
            raise ValueError(f"params are cut for {_tp_size(cfg, params)} tp "
                             f"ranks, the mesh has {n_tp}")
        b_all, t_all = tokens.shape
        if b_all % n_dp or t_all % n_sp:
            raise ValueError(f"batch {b_all} x sequence {t_all} does not split "
                             f"over {n_dp} dp x {n_sp} sp ranks")
        b, t = b_all // n_dp, t_all // n_sp
        if b % m:
            raise ValueError(f"local batch {b} must divide into {m} microbatches")

        def cut(x):             # (B, T) -> (*held, b, t)
            return _place(x.view(n_dp, b, n_sp, t).transpose(1, 2),
                          [dp_axis, sp_axis], held)

        positions = _sp_positions(n_sp, t, tokens.device, after=k - sp_dim - 1)
        own = {name: _leaf(leaf(name, p)) for name, p in params.items()}
        stage = {name: own[name] for name in _4D_STAGE_KEYS}
        lead = tuple(held.values())
        e = _embed(own["embed"], cut(tokens)).reshape(lead + (m, b // m, t, cfg.d_model))

        def stage_fn(sp_, x):
            for i in range(L_local):
                layer = {name: w.select(k + tp_cut(name), i) for name, w in sp_.items()}
                x = _attn_ffn_block(cfg, layer, x, positions, tp_axis=tp_axis,
                                    sp_axis=sp_axis if n_sp > 1 else None,
                                    sp_dim=sp_dim)
            return x

        acts = pipeline_forward(stage_fn, stage, e, axis=pp_axis, mesh=held)
        acts = acts.reshape(lead + (b, t, cfg.d_model))
        logits = _matmul(_rms_norm(acts, own["ln_f"]),
                         own["embed"].transpose(-1, -2)).to(torch.float32)
        loss = _last_stage_loss(logits, cut(labels), held, pp_axis)
        grads = torch.autograd.grad(loss.sum(), list(own.values()))
        new = {}
        for (name, p), g in zip(params.items(), grads):
            if name in ("embed", "ln_f"):
                g = _psum(g, (dp_axis, sp_axis, pp_axis), held)
            else:
                g = _psum(g, (dp_axis, sp_axis), cut_layout if tp_cut(name) else held)
            new[name] = (p - lr * unleaf(name, g)).to(p.dtype)
        loss = _pmean(loss.detach(), (dp_axis, sp_axis), held)
        return new, loss.reshape(-1)[0]

    return step, specs
