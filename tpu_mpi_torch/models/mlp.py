"""Data-parallel MLP: the minimum end-to-end training slice — the port of
``tpu_mpi/models/mlp.py``.

Params enter replicated (held once), each rank runs the forward and
backward on its batch shard, the per-rank gradients are summed over the
``dp`` axis in rank order (:func:`tpu_mpi_torch.parallel.dp.allreduce_grads`,
the fused fold kernel on a CUDA tensor) and averaged, and every rank takes
the same SGD step. The n ranks share one card, so the batch shards are
stacked, rank axis first.
"""

from __future__ import annotations

from typing import Any

import torch

from ..buffers import resolve_device
from ..parallel import dp as _dp


def mlp_init(generator: torch.Generator, sizes: list, device: Any = None) -> list:
    """Layers ``[{"w": (a, b), "b": (b,)}, ...]`` in float32 on ``device``
    (default ``cuda``): w normal(0, 1) * sqrt(2 / a) drawn from
    ``generator`` on its own device, b zeros."""
    dev = resolve_device(device)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator, dtype=torch.float32,
                        device=generator.device) * (2.0 / a) ** 0.5
        params.append({"w": w.to(dev), "b": torch.zeros(b, device=dev)})
    return params


def _forward(params: list, x: torch.Tensor) -> torch.Tensor:
    """Per-rank forward of stacked params (n, a, b) / (n, b) on x (n, m, a)."""
    for i, layer in enumerate(params):
        x = torch.matmul(x, layer["w"]) + layer["b"].unsqueeze(1)
        if i != len(params) - 1:
            x = torch.relu(x)
    return x


def mlp_train_step_dp(params: list, x: torch.Tensor, y: torch.Tensor,
                      lr: float = 1e-2, axis: str = "dp"):
    """One SGD step on stacked batch shards x (n, m, a), y (n, m, out);
    grads all-reduced (mean) over ``axis``. Returns (params, loss): the
    updated params, held once, and the mean of the ranks' losses."""
    n = x.shape[0]
    ranked = _dp.replicate_tree(params, n)
    losses = ((_forward(ranked, x) - y) ** 2).flatten(1).mean(1)     # (n,)
    grads = torch.autograd.grad(losses.sum(), _dp.leaves(ranked))
    grads = _dp.allreduce_grads(list(grads), axis=axis, mean=True)
    new = [p - lr * g[0] for p, g in zip(_dp.leaves(params), grads)]
    loss = _dp.pmean_tree(losses.detach(), axis=axis)[0]
    return _dp.unflatten(params, new), loss
