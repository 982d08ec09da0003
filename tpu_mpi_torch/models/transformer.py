"""Flagship model: a GPT-style transformer trained over one of DP, TP or SP
— the port of ``tpu_mpi/models/transformer.py``.

Pre-norm attention + FFN layers with RoPE by global position. Attention
heads and FFN hidden units shard over a ``tp`` axis (Megatron
column/row-parallel with the f/g pair, :mod:`tpu_mpi_torch.parallel.tp`),
the sequence shards over an ``sp`` axis with exact ring attention
(:mod:`tpu_mpi_torch.parallel.ring`, the ring-attention kernel on a CUDA
tensor), or the batch shards over a ``dp`` axis. The ranks of a mesh share
one card and per-rank tensors are stacked, rank axis first; what is the
same on every tp rank (the residual stream) is held once.

:func:`transformer_train_step` builds the SGD step over a mesh of one live
axis, differentiated by autograd: the per-rank gradients of the dp/sp
ranks are summed with the fused fold kernel, one launch per parameter
tensor, as the JAX step psums each leaf.

Parameters are a plain dictionary of tensors shaped as the JAX package's
pytree (``layers`` a list of per-layer dictionaries), so
:func:`params_from_jax` carries a JAX model's weights across unchanged.
Steps over two live axes at once and the pipelined MoE and 4-axis
variants wait for the multi-axis mesh (ROADMAP Queue A #8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..buffers import resolve_device
from ..parallel import dp as _dp
from ..parallel.ring import ring_attention
from ..parallel.tp import _per_rank_matmul, column_parallel, row_parallel
from ..xla.mesh import _TOPOLOGY


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


def transformer_init(generator: torch.Generator, cfg: TransformerConfig,
                     device: Any = None) -> dict:
    """Random weights on ``device`` (default ``cuda``), with the JAX
    package's shapes and scales: normal(0, 1) * scale in float32, drawn
    from ``generator`` on its own device, cast to ``cfg.dtype``; norm
    scales are ones. A seeded CPU generator gives the same weights on
    every ``device``; raises when CUDA is asked for and absent."""
    dev = resolve_device(device)

    def dense(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * scale).to(device=dev, dtype=cfg.dtype)

    def ones(d):
        return torch.ones(d, dtype=cfg.dtype, device=dev)

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
    """The tp shards of ``params`` for n ranks, stacked rank axis first:
    a column-sharded (d, c) weight becomes (n, d, c/n) with rank r's
    contiguous columns (``w_qkv`` is packed per head, so a shard holds
    whole heads), a row-sharded (k, d) weight (n, k/n, d); replicated
    parameters stay as they are."""
    specs = transformer_param_specs(cfg, tp_axis)

    def cut(x: torch.Tensor, spec: tuple) -> torch.Tensor:
        for dim, name in enumerate(spec):
            if name is not None:
                if x.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of size {x.shape[dim]} "
                                     f"does not split over {n} ranks")
                return x.unflatten(dim, (n, -1)).movedim(dim, 0).contiguous()
        return x

    return {
        "embed": cut(params["embed"], specs["embed"]),
        "ln_f": cut(params["ln_f"], specs["ln_f"]),
        "layers": [{k: cut(v, spec[k]) for k, v in layer.items()}
                   for layer, spec in zip(params["layers"], specs["layers"])],
    }


def params_from_jax(params_np: Mapping[str, Any], cfg: TransformerConfig,
                    device: Any) -> dict:
    """The JAX model's parameter pytree, as numpy arrays (``layers`` a list
    of dictionaries), as the port's dictionary of ``cfg.dtype`` tensors on
    ``device``. Float32 and bfloat16 arrays carry across exactly (via
    float32)."""
    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=cfg.dtype)

    return {
        "embed": conv(params_np["embed"]),
        "ln_f": conv(params_np["ln_f"]),
        "layers": [{k: conv(v) for k, v in layer.items()}
                   for layer in params_np["layers"]],
    }


def _per_rank_scale(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A norm scale for x: held once (d,), or stacked per rank (n, d) and
    viewed to broadcast over x's (n, ..., d)."""
    if scale.dim() == 1:
        return scale
    return scale.view((scale.shape[0],) + (1,) * (x.dim() - 2) + (scale.shape[-1],))


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for a weight held once (d_in, d_out), or rank r's x times its
    own w for a weight stacked per rank (n, d_in, d_out)."""
    return x @ w if w.dim() == 2 else _per_rank_matmul(x, w)


def _embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding for tokens; a stacked (n, V, d) embedding
    looks rank r's tokens up in its own copy."""
    if embed.dim() == 2:
        return embed[tokens]
    ranks = torch.arange(embed.shape[0], device=tokens.device)
    return embed[ranks.view((-1,) + (1,) * (tokens.dim() - 1)), tokens]


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * _per_rank_scale(scale, x)


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings of x (..., t, dh); ``positions`` (broadcasting to
    x's (..., t)) are *global*, so sequence shards agree."""
    half = x.shape[-1] // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(10000.0, exps)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., t, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _sp_positions(n: int, t: int, device: Any) -> torch.Tensor:
    """Global positions of n stacked sequence blocks of t: (n, 1, 1, t)."""
    ranks = torch.arange(n, device=device)[:, None]
    return (ranks * t + torch.arange(t, device=device)).view(n, 1, 1, t)


def _tp_size(cfg: TransformerConfig, params: dict) -> int:
    n = params["layers"][0]["w_qkv"].shape[0] if params["layers"] else 1
    if cfg.n_heads % n:
        raise ValueError(f"n_heads={cfg.n_heads} must be divisible by tp size {n}")
    return n


def transformer_forward(cfg: TransformerConfig, params: dict,
                        tokens: torch.Tensor, *, tp_axis: Optional[str] = None,
                        sp_axis: Optional[str] = None) -> torch.Tensor:
    """Logits (float32) for a token block.

    - both axes None: tokens (b, t) int, params from
      :func:`transformer_init`; returns (b, t, V).
    - ``sp_axis``: tokens stacked (n, b, t_local), rank r holding global
      positions ``r*t_local ..``; returns the stacked (n, b, t_local, V).
    - ``tp_axis``: tokens (b, t) replicated, params from
      :func:`shard_params`; returns the stacked (n, b, t, V), every rank's
      the same (one tensor, viewed n times).
    One mesh axis at a time: both raise NotImplementedError."""
    if tp_axis is not None and sp_axis is not None:
        raise NotImplementedError(_TOPOLOGY)
    t = tokens.shape[-1]
    if sp_axis is not None:
        positions = _sp_positions(tokens.shape[0], t, tokens.device)
    else:
        positions = torch.arange(t, device=tokens.device)
    logits = _logits(cfg, params, tokens, positions, tp_axis=tp_axis,
                     sp_axis=sp_axis)
    if tp_axis is None:
        return logits
    n = _tp_size(cfg, params)
    return logits.unsqueeze(0).expand((n,) + tuple(logits.shape))


def _logits(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor, *, tp_axis: Optional[str],
            sp_axis: Optional[str]) -> torch.Tensor:
    """The forward at its native layout: held once under tp, per rank
    under sp (and for per-rank params, stacked (n, ...))."""
    x = _embed(params["embed"], tokens)
    for layer in params["layers"]:
        x = _attn_ffn_block(cfg, layer, x, positions, tp_axis=tp_axis,
                            sp_axis=sp_axis)
    x = _rms_norm(x, params["ln_f"])
    return _matmul(x, params["embed"].transpose(-1, -2)).to(torch.float32)


def _attn_ffn_block(cfg: TransformerConfig, layer: dict, x: torch.Tensor,
                    positions: torch.Tensor, *, tp_axis: Optional[str],
                    sp_axis: Optional[str]) -> torch.Tensor:
    """One transformer layer (pre-norm attention + FFN) on x (..., b, t, d):
    held once under tp (the heads and FFN units per rank in between), with
    a leading rank axis under sp. A layer's weights may be stacked per
    rank, (n, ...), to take per-rank gradients."""
    b, t, _ = x.shape[-3:]
    dh = cfg.head_dim

    # -- attention --
    y = _rms_norm(x, layer["ln1"])
    if tp_axis is not None:
        qkv = column_parallel(y, layer["w_qkv"], axis=tp_axis)    # (n, b, t, 3d/n)
    else:
        qkv = _matmul(y, layer["w_qkv"])                          # (..., b, t, 3d)
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
        o = ring_attention(q, k, v, axis=sp_axis, causal=True)
    else:
        s = torch.matmul(q * dh ** -0.5, k.transpose(-1, -2))
        mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~mask, -1e30)
        o = torch.matmul(torch.softmax(s, dim=-1), v)
    o = o.transpose(L + 1, L + 2).reshape(lead + (b, t, h_local * dh))
    if tp_axis is not None:
        x = x + row_parallel(o, layer["w_proj"], axis=tp_axis)
    else:
        x = x + _matmul(o, layer["w_proj"])

    # -- feed-forward (jax.nn.gelu's default is the tanh approximation) --
    y = _rms_norm(x, layer["ln2"])
    if tp_axis is not None:
        hmid = F.gelu(column_parallel(y, layer["w_in"], axis=tp_axis),
                      approximate="tanh")
        x = x + row_parallel(hmid, layer["w_out"], axis=tp_axis)
    else:
        hmid = F.gelu(_matmul(y, layer["w_in"]), approximate="tanh")
        x = x + _matmul(hmid, layer["w_out"])
    return x


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of logits (..., V) against labels."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -ll.mean()


def transformer_train_step(cfg: TransformerConfig, mesh, lr: float = 1e-2, *,
                           dp_axis: str = "dp", tp_axis: str = "tp",
                           sp_axis: str = "sp"):
    """Build the SGD train step over ``mesh``: batch over ``dp_axis``,
    heads and FFN units over ``tp_axis`` or the sequence over ``sp_axis``,
    whichever one of them the mesh carries (an axis the mesh lacks has size
    1; two live axes raise NotImplementedError).

    Returns (step, param_specs): ``step(params, tokens, labels) -> (params,
    loss)`` with tokens/labels the global (batch, seq) integer tensors and
    params laid out as on that mesh's forward (:func:`shard_params` under
    tp, as :func:`transformer_init` gives them otherwise). As in the JAX
    step, each rank's loss is the mean over its own tokens, the dp/sp ranks'
    gradients are summed (the fused fold kernel, one launch per parameter
    tensor), tp gradients come out whole from the f/g pair, the update is
    ``(p - lr * g).to(p.dtype)`` and the loss is the ranks' mean."""
    specs = transformer_param_specs(cfg, tp_axis)
    names = (dp_axis, tp_axis, sp_axis)
    if not any(a in mesh.axis_names for a in names):
        raise ValueError(f"mesh axes {mesh.axis_names} name none of {names}")
    live = [a for a in names if a in mesh.axis_names and mesh.axis_size(a) > 1]
    if len(live) > 1:
        raise NotImplementedError(_TOPOLOGY)
    axis = live[0] if live else None
    n = mesh.axis_size(axis) if axis else 1

    def sgd(params, grads):
        new = [(p - lr * g).to(p.dtype) for p, g in zip(_dp.leaves(params), grads)]
        return _dp.unflatten(params, new)

    def tp_step(params, tokens, labels):
        _tp_size(cfg, params)
        own = _dp.tree_map(lambda p: p.detach().requires_grad_(), params)
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
        loss = _xent(_logits(cfg, own, tokens, positions, tp_axis=tp_axis,
                             sp_axis=None), labels)
        grads = torch.autograd.grad(loss, _dp.leaves(own))
        return sgd(params, grads), loss.detach()

    def ranked_step(params, tokens, labels):
        b, t = tokens.shape
        if axis == sp_axis:
            if t % n:
                raise ValueError(f"sequence {t} does not split over {n} sp ranks")
            cut = lambda x: x.view(b, n, t // n).transpose(0, 1)   # noqa: E731
            positions = _sp_positions(n, t // n, tokens.device)
        else:
            if b % n:
                raise ValueError(f"batch {b} does not split over {n} dp ranks")
            cut = lambda x: x.view(n, b // n, t)                    # noqa: E731
            positions = torch.arange(t, device=tokens.device)
        ranked = _dp.replicate_tree(params, n)
        logits = _logits(cfg, ranked, cut(tokens), positions, tp_axis=None,
                         sp_axis=sp_axis if axis == sp_axis else None)
        losses = torch.stack([_xent(lg, lb) for lg, lb in zip(logits, cut(labels))])
        grads = torch.autograd.grad(losses.sum(), _dp.leaves(ranked))
        grads = _dp.allreduce_grads(list(grads), axis=axis or sp_axis, mean=False)
        loss = _dp.pmean_tree(losses.detach(), axis=axis or sp_axis)[0]
        return sgd(params, [g[0] for g in grads]), loss

    return (tp_step if axis == tp_axis else ranked_step), specs
