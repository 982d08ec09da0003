"""What the flagship's training drivers share: the configuration file's
sizes, the program's config object, leaf norms and the counters a traced
run prints."""

from __future__ import annotations

import torch

# configuration-file keys (GPT-2's names, where GPT-2 has the size) -> the
# names inputs, counts and the reference use
SIZES = {"vocab": "vocab_size", "d_model": "n_embd", "n_heads": "n_head",
         "n_layers": "n_layer", "d_ff": "n_inner", "seq": "n_positions"}


def model_cfg(config: dict) -> dict:
    return {k: int(config[v]) for k, v in SIZES.items()}


def program_cfg(tr, m: dict, dtype: torch.dtype):
    """The port's ``TransformerConfig`` at these sizes."""
    return tr.TransformerConfig(vocab=m["vocab"], d_model=m["d_model"],
                                n_heads=m["n_heads"], n_layers=m["n_layers"],
                                d_ff=m["d_ff"], max_seq=m["seq"], dtype=dtype)


def norms(tensors: dict) -> dict:
    return {k: float(t.double().norm()) for k, t in tensors.items()}


def moved_share(before: dict, after: dict) -> float:
    """The share of all elements that a step changed."""
    moved = sum(int((before[k] != after[k]).sum()) for k in before)
    return moved / sum(t.numel() for t in before.values())


def counters() -> dict:
    """The program's launch counts of its hand-written kernels, and folds
    that left the fold kernel."""
    from tpu_mpi_torch import collective
    from tpu_mpi_torch.kernels import attention, fused_reduce
    return {"fold_launches": fused_reduce.launches,
            "attention_launches": attention.launches,
            "attention_route_launches": dict(attention.route_launches),
            "chained_folds": collective.chained_folds}
