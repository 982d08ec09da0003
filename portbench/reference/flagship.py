"""The flagship transformer's equations in plain PyTorch, for judging the
port's train steps. A frozen copy written from the model's description; it
imports nothing of tpu_mpi_torch.

The block: token embedding (tied with the output projection); per layer a
pre-norm causal self-attention (RMSNorm with eps 1e-6 and a scale, a packed
qkv projection laid out [head][q|k|v][head_dim], rotary embeddings of the
rotate-half form with base 10000 over global positions, softmax of the
scores scaled by head_dim^-0.5) and a pre-norm FFN (tanh-approximated GELU),
each added to the residual stream; a final RMSNorm; float32 logits and the
mean next-token cross-entropy.

The reference computes in float32 with TF32 off. ``quant``, when given,
rounds both operands of every matrix product first: that is the control,
the same equations at a lower precision. ``fault`` plants one of the
faults a broken train step can have, so that its readings can be taken.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

FAULTS = ("half_batch", "no_exchange", "altered")
ALTERED_LEAF = "layers.0.w_in"      # the leaf whose gradient "altered" doubles


@contextlib.contextmanager
def exact_matmul():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude to 448), as a float8 product would take it; the gradient
    passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * scale


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    freqs = 1.0 / torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                                  device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def forward(cfg: dict, w: dict, tokens: torch.Tensor,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """float32 logits (b, t, vocab) of tokens (b, t) under the float32 flat
    weights ``w``."""
    def mm(a, b):
        return quant(a) @ quant(b) if quant is not None else a @ b

    b, t = tokens.shape
    h = cfg["n_heads"]
    dh = cfg["d_model"] // h
    pos = torch.arange(t, device=tokens.device)
    keep = torch.ones((t, t), dtype=torch.bool, device=tokens.device).tril()
    x = w["embed"][tokens]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        qkv = mm(rms_norm(x, w[p + "ln1"]), w[p + "w_qkv"]).view(b, t, h, 3, dh)
        q, k, v = (qkv[:, :, :, j, :].transpose(1, 2) for j in range(3))
        q, k = rope(q, pos), rope(k, pos)
        s = mm(q, k.transpose(-1, -2)) * dh ** -0.5
        att = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        o = mm(att, v).transpose(1, 2).reshape(b, t, h * dh)
        x = x + mm(o, w[p + "w_proj"])
        hid = F.gelu(mm(rms_norm(x, w[p + "ln2"]), w[p + "w_in"]), approximate="tanh")
        x = x + mm(hid, w[p + "w_out"])
    return mm(rms_norm(x, w["ln_f"]), w["embed"].t())


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def _norms(tensors: dict) -> dict:
    return {k: float(t.double().norm()) for k, t in tensors.items()}


def _grads(cfg: dict, w: dict, tokens, labels, shards: int, quant, fault,
           block_rows: int) -> tuple:
    """The gradient of the sum over ``shards`` sequence blocks of each
    block's mean loss, computed ``block_rows`` rows at a time, and that
    sum's value. ``no_exchange`` keeps block 0's loss alone."""
    rows, t = tokens.shape
    if fault == "half_batch":
        rows //= 2
        tokens, labels = tokens[:rows], labels[:rows]
    per = t // shards
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    acc = {k: torch.zeros_like(v) for k, v in w.items()}
    total = 0.0
    for lo in range(0, rows, block_rows):
        hi = min(rows, lo + block_rows)
        logits = forward(cfg, leaves, tokens[lo:hi], quant)
        used = 1 if fault == "no_exchange" else shards
        loss = sum(xent(logits[:, r * per:(r + 1) * per], labels[lo:hi, r * per:(r + 1) * per])
                   for r in range(used)) * ((hi - lo) / rows)
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
            acc[k] += g
        total += float(loss.detach())
        del logits, loss
    if fault == "altered":
        acc[ALTERED_LEAF] *= 2
    return acc, total


def sgd_steps(cfg: dict, init: dict, tokens, labels, *, lr: float, shards: int,
              steps: int, store: torch.dtype, quant=None, fault=None,
              block_rows: int = 2) -> dict:
    """The sequence-parallel train step's arithmetic, ``steps`` times: the
    gradient of the sum of the ``shards`` sequence blocks' mean losses, then
    ``p - lr * g`` rounded to the weights' stored type ``store``. The loss
    reported is the blocks' mean. ``tokens`` and ``labels`` are (steps,
    rows, t).

    Returns the losses, and by leaf the norms of the first gradient as the
    update shows it ((p0 - p1) / lr), of the change after all steps, and of
    the first float32 gradient itself (``grad``: for leaving out leaves that
    rounding alone moves)."""
    p0 = {k: v.float() for k, v in init.items()}
    p, losses, rec = dict(p0), [], {}
    with exact_matmul():
        for s in range(steps):
            g, total = _grads(cfg, p, tokens[s], labels[s], shards, quant, fault,
                              block_rows)
            losses.append([total / shards])
            p = {k: (v - lr * g[k]).to(store).float() for k, v in p.items()}
            if s == 0:
                rec["grad"] = _norms(g)
                rec["grad1"] = [_norms({k: (p0[k] - p[k]) / lr for k in p})]
            del g
    rec["losses"] = losses
    rec["change"] = [_norms({k: p[k] - p0[k] for k in p})]
    return rec


def ddp_steps(cfg: dict, init: dict, tokens, labels, *, ranks: int, lr: float,
              momentum: float, steps: int, quant=None, fault=None,
              block_rows: int = 2) -> dict:
    """The data-parallel trainer's arithmetic, ``steps`` times: each rank's
    mean loss on its own rows (rank r holds rows [r*rows/ranks, ...) of each
    (rows, t) batch), the gradients added in rank order in float64 and
    divided by the ranks, SGD with momentum on float64 masters. The forward
    reads the masters as float32. ``no_exchange`` gives each rank its own
    gradient alone.

    Returns, by rank, the losses and, by leaf, the norms of the first
    gradient as the masters show it and of the change after all steps;
    ``grad`` the first mean gradient's norms."""
    per = tokens.shape[1] // ranks
    p0 = {k: v.double() for k, v in init.items()}
    masters = [{k: v.clone() for k, v in p0.items()} for _ in range(ranks)]
    moms = [{k: torch.zeros_like(v) for k, v in p0.items()} for _ in range(ranks)]
    losses, rec = [], {}
    with exact_matmul():
        for s in range(steps):
            grads, row = [], []
            for r in range(ranks):
                w = {k: v.float() for k, v in masters[r].items()}
                g, total = _grads(cfg, w, tokens[s, r * per:(r + 1) * per],
                                  labels[s, r * per:(r + 1) * per], 1, quant,
                                  None if fault == "no_exchange" else fault, block_rows)
                grads.append(g)
                row.append(total)
            losses.append(row)
            for r in range(ranks):
                for k in p0:
                    if fault == "no_exchange":
                        mean = grads[r][k].double()
                    else:
                        total = grads[0][k].double()
                        for q in range(1, ranks):
                            total = total + grads[q][k].double()
                        mean = total * (1.0 / ranks)
                    moms[r][k].mul_(momentum).add_(mean)
                    masters[r][k].sub_(moms[r][k] * lr)
            if s == 0:
                rec["grad"] = _norms(moms[0])
                rec["grad1"] = [_norms({k: (p0[k] - m[k]) / lr for k in p0})
                                for m in masters]
            del grads
    rec["losses"] = losses
    rec["change"] = [_norms({k: m[k] - p0[k] for k in p0}) for m in masters]
    return rec
