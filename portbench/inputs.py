"""Every input of a run, made from its seed: the collective cells' operands,
the flagship's weights and its token batches.

The benchmark makes them and hands the same tensors, or the same values made
again from the seed, to the program and to the reference. Everything is drawn
on the run's device by a ``torch.Generator`` there, in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch

# one stream of random numbers per kind of input, so that adding a kind
# leaves the others as they were
STREAM_OPERANDS, STREAM_WEIGHTS, STREAM_TOKENS, STREAM_ORDER = 1, 2, 3, 4


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of one run; any whole ``seed``, of any
    sign and size, is taken."""
    state = np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for orders and samples (never for data)."""
    return np.random.default_rng(stream_seed(seed, stream))


def operands(seed: int, ranks: int, counts: list, dtype: torch.dtype,
             device: torch.device) -> list:
    """``out[i][r]``: rank r's operand of ``counts[i]`` elements, standard
    normal values in ``dtype``, each its own allocation."""
    gen = generator(seed, STREAM_OPERANDS, device)
    total = ranks * sum(counts)
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device).to(dtype)
    out, off = [], 0
    for n in counts:
        out.append([flat[off + r * n:off + (r + 1) * n].clone() for r in range(ranks)])
        off += ranks * n
    del flat
    return out


def flagship_shapes(cfg: dict) -> list:
    """(name, shape, scale) of every weight in forward order; a scale of
    None is a norm's ones. The names are the trainers' flat names."""
    d, f, L, v = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], cfg["vocab"]
    out = [("embed", (v, d), d ** -0.5)]
    for i in range(L):
        out += [(f"layers.{i}.ln1", (d,), None),
                (f"layers.{i}.w_qkv", (d, 3 * d), d ** -0.5),
                (f"layers.{i}.w_proj", (d, d), (2 * d * L) ** -0.5),
                (f"layers.{i}.ln2", (d,), None),
                (f"layers.{i}.w_in", (d, f), d ** -0.5),
                (f"layers.{i}.w_out", (f, d), (2 * f * L) ** -0.5)]
    out.append(("ln_f", (d,), None))
    return out


def flagship_weights(seed: int, cfg: dict, dtype: torch.dtype,
                     device: torch.device) -> dict:
    """The flagship's weights by flat name: normal(0, 1) times the model's
    scale, drawn as one float32 block and cast to ``dtype``; norms are
    ones."""
    shapes = flagship_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s, scale in shapes if scale is not None)
    gen = generator(seed, STREAM_WEIGHTS, device)
    block = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for name, shape, scale in shapes:
        if scale is None:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        n = int(np.prod(shape))
        out[name] = (block[off:off + n].view(shape) * scale).to(dtype)
        off += n
    del block
    return out


def nest(flat: dict, n_layers: int) -> dict:
    """Flat names to the model's nested dictionary (embed, layers, ln_f)."""
    return {"embed": flat["embed"], "ln_f": flat["ln_f"],
            "layers": [{k.split(".")[2]: w for k, w in flat.items()
                        if k.startswith(f"layers.{i}.")} for i in range(n_layers)]}


def flatten(params: dict) -> dict:
    """The model's nested dictionary to flat names, in forward order."""
    out = {"embed": params["embed"]}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": w for k, w in layer.items()})
    out["ln_f"] = params["ln_f"]
    return out


def token_batches(seed: int, steps: int, rows: int, seq: int, vocab: int,
                  device: torch.device) -> tuple:
    """``steps`` batches of ``rows`` sequences, every row its own draw:
    tokens (steps, rows, seq) and labels, the same sequences one position
    on, both contiguous int64. Which value lands where may depend on the
    size of the draw, so a reference that needs the first batches draws
    them at the same ``steps`` and slices."""
    gen = generator(seed, STREAM_TOKENS, device)
    seqs = torch.randint(0, vocab, (steps, rows, seq + 1), generator=gen,
                         device=device)
    return seqs[..., :seq].contiguous(), seqs[..., 1:].contiguous()
