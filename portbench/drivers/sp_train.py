"""Sequence-parallel training of the flagship with the port's
``transformer_train_step`` on an in-graph mesh.

Traffic keys: ``mesh`` (``{"sp": n}``), ``rows`` (the global batch's
sequences), ``batches`` (seeded batches made up front; the window cycles
through them), ``lr``, ``checked_steps``.

The step takes the weights, the (rows, seq) tokens and their next tokens
as labels, and gives back the new weights and the loss. Set-up takes it
through ``checked_steps`` steps, and the window goes on from there with the
same step function. The check compares those first steps with the
reference's (``reference.flagship.sgd_steps``).
"""

from __future__ import annotations

import time

import torch

from .. import inputs
from ..check import train_numbers
from ..counts import flagship_step_flops
from ..harness import (Facts, memory_peak, minus, process_start_unix,
                       release_device_memory, synchronize)
from ..reference import flagship as ref
from .flagship import counters, model_cfg, moved_share, norms, program_cfg


def run(cell) -> Facts:
    from tpu_mpi_torch import xla
    from tpu_mpi_torch.models import transformer as tr
    m, t, device = model_cfg(cell.config), cell.traffic, cell.device
    dtype = getattr(torch, cell.config["dtype"])
    pcfg = program_cfg(tr, m, dtype)
    rows, lr, checked = int(t["rows"]), float(t["lr"]), int(t["checked_steps"])
    pool = int(t["batches"])
    shards = int(t["mesh"]["sp"])
    init = inputs.flagship_weights(cell.seed, m, dtype, device)
    tokens, labels = inputs.token_batches(cell.seed, pool, rows, m["seq"], m["vocab"], device)
    step, _ = tr.transformer_train_step(pcfg, xla.make_mesh(t["mesh"], devices=[device]),
                                        lr=lr)
    marks = {}
    windows = cell.windows(on_open=lambda: marks.update(counters=counters()))

    params, losses = inputs.nest(init, m["n_layers"]), []
    for s in range(checked):
        params, loss = step(params, tokens[s], labels[s])
        losses.append([float(loss)])
        if s == 0:
            flat = inputs.flatten(params)
            grad1 = norms({k: (init[k].float() - flat[k].float()) / lr for k in init})
            moved = moved_share(init, flat)
    flat = inputs.flatten(params)
    got = {"losses": losses, "grad1": [grad1],
           "change": [norms({k: flat[k].float() - init[k].float() for k in init})]}
    del flat
    spans = cell.spans.mine()
    clock = time.perf_counter_ns
    s, counts = checked, []
    for window in windows:
        synchronize(device)
        cell.trace_start(window)
        window.open()
        first = s
        while window.go_on(s - first):
            a = clock()
            params, loss = step(params, tokens[s % pool], labels[s % pool])
            spans.append(("train_step", a, clock()))
            s += 1
        synchronize(device)
        window.close()
        counts.append(s - first)
        marks.setdefault("after", counters())
        cell.trace_stop(window)
    peak = memory_peak(device)
    del params, loss, init, tokens, labels, step
    release_device_memory()

    init = inputs.flagship_weights(cell.seed, m, dtype, device)
    tokens, labels = (x[:checked] for x in inputs.token_batches(
        cell.seed, pool, rows, m["seq"], m["vocab"], device))
    want = ref.sgd_steps(m, init, tokens, labels, lr=lr, shards=shards, steps=checked,
                         store=dtype)
    timed, n = windows[0], counts[0]
    traced = windows[1] if len(windows) > 1 else None
    notes = [timed.note(), f"portbench: {n} steps in {timed.seconds_measured:.3f} s; losses of the "
             f"checked steps {got['losses']} (reference {want['losses']}); the first "
             f"step changed {moved:.4f} of the weights' elements"]
    return Facts(attempted=n, failed=0, ops=n, window=(timed.start_ns, timed.end_ns),
                 setup_s=timed.start_unix - process_start_unix(),
                 memory_peak_bytes=peak, numbers=train_numbers(got, want),
                 tokens_per_step=rows * m["seq"],
                 flops_per_step=flagship_step_flops(m, rows, m["seq"]),
                 traced_ops=counts[1] if traced else 0,
                 traced_window=(traced.start_ns, traced.end_ns) if traced else None,
                 counters=minus(marks["after"], marks["counters"]), notes=notes)
