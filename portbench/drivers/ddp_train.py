"""Data-parallel training of the flagship on rank threads with the port's
``DDPTrainer``.

Traffic keys: ``ranks``, ``rows_per_rank`` (each rank's own rows of every
batch), ``batches`` (seeded batches made up front; the window cycles
through them), ``bucket_bytes``, ``lr``, ``momentum``, ``checked_steps``.

Each rank casts the trainer's float64 masters to the model's type, runs the
forward and backward on its own rows (labels are the next tokens) and hands
``DDPTrainer.step`` the gradients in reverse order. Set-up builds the
trainers and takes them through ``checked_steps`` steps of the window's own
call; the window goes on with the same trainers. The check compares those
first steps with the reference's (``reference.flagship.ddp_steps``).
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
from .flagship import counters, model_cfg, norms, program_cfg


def run(cell) -> Facts:
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import perfvars
    from tpu_mpi_torch.models import transformer as tr
    from tpu_mpi_torch.train import DDPTrainer
    m, t, device = model_cfg(cell.config), cell.traffic, cell.device
    dtype = getattr(torch, cell.config["dtype"])
    pcfg = program_cfg(tr, m, dtype)
    ranks, rows = int(t["ranks"]), int(t["rows_per_rank"])
    lr, mu, checked = float(t["lr"]), float(t["momentum"]), int(t["checked_steps"])
    pool = int(t["batches"])
    init = inputs.flagship_weights(cell.seed, m, dtype, device)
    tokens, labels = inputs.token_batches(cell.seed, pool, ranks * rows, m["seq"],
                                          m["vocab"], device)
    names = list(init)
    marks = {}

    def on_open():
        marks["train"] = perfvars.train_snapshot()
        marks["counters"] = counters()

    windows = cell.windows(on_open=on_open)

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        mine = slice(r * rows, (r + 1) * rows)
        ddp = DDPTrainer(init, comm, lr=lr, momentum=mu,
                         bucket_bytes=int(t["bucket_bytes"]), device=device)
        spans = cell.spans.mine(r)
        clock = time.perf_counter_ns

        def step(s):
            b = s % pool
            a = clock()
            model = {k: w.to(dtype).requires_grad_() for k, w in ddp.params.items()}
            c = clock()
            logits = tr.transformer_forward(pcfg, inputs.nest(model, m["n_layers"]),
                                            tokens[b, mine])
            loss = tr._xent(logits, labels[b, mine])
            grads = dict(zip(model, torch.autograd.grad(loss, list(model.values()))))
            del model, logits
            d = clock()
            ddp.step((k, grads[k]) for k in reversed(names))
            e = clock()
            spans.append(("cast", a, c))
            spans.append(("forward_backward", c, d))
            spans.append(("trainer.step", d, e))
            return loss.detach()

        rec = {"losses": []}
        for s in range(checked):
            rec["losses"].append(float(step(s)))
            if s == 0:
                rec["grad1"] = norms({k: (init[k].double() - ddp.params[k]) / lr
                                      for k in names})
        rec["change"] = norms({k: ddp.params[k] - init[k].double() for k in names})
        s, counts = checked, []
        for window in windows:
            synchronize(device)
            MPI.Barrier(comm)
            if r == 0:
                cell.trace_start(window)
            MPI.Barrier(comm)
            window.open()
            first = s
            while window.go_on(s - first):
                step(s)
                s += 1
            synchronize(device)
            window.close()
            counts.append(s - first)
            MPI.Barrier(comm)
            if r == 0:
                cell.trace_stop(window)
                if "train_after" not in marks:
                    marks["train_after"] = perfvars.train_snapshot()
                    marks["counters_after"] = counters()
        MPI.Finalize()
        return rec, counts

    out = MPI.spmd_run(body, ranks)
    peak = memory_peak(device)
    steps, traced_steps = (out[0][1] + [0])[:2]
    recs = [o[0] for o in out]
    got = {"losses": [[rec["losses"][s] for rec in recs] for s in range(checked)],
           "grad1": [rec["grad1"] for rec in recs],
           "change": [rec["change"] for rec in recs]}
    del out, recs, init, tokens, labels
    release_device_memory()

    # the reference: weights and batches made again from the seed
    init = inputs.flagship_weights(cell.seed, m, dtype, device)
    tokens, labels = (x[:checked] for x in inputs.token_batches(
        cell.seed, pool, ranks * rows, m["seq"], m["vocab"], device))
    want = ref.ddp_steps(m, init, tokens, labels, ranks=ranks, lr=lr, momentum=mu,
                         steps=checked)
    numbers = train_numbers(got, want)
    before, after = marks["train"], marks["train_after"]
    counts = {"train": {k: after.get(k, 0) - before.get(k, 0)
                        for k in ("steps", "step_ns", "wait_ns", "comm_window_ns",
                                  "bucket_flushes")},
              **minus(marks["counters_after"], marks["counters"])}
    timed = windows[0]
    starts = [a for n, a, _ in cell.spans.of(0) if n == "cast" and a >= timed.start_ns]
    step_ms = [round((y - x) / 1e6, 1) for x, y in zip(starts, starts[1:steps])]
    notes = [timed.note(), f"portbench: {steps} steps in {timed.seconds_measured:.3f} s, rank 0's "
             f"steps {step_ms} ms; "
             f"losses of the checked steps {got['losses']} (reference {want['losses']})"]
    traced = windows[1] if len(windows) > 1 else None
    return Facts(attempted=steps, failed=0, ops=steps,
                 window=(timed.start_ns, timed.end_ns),
                 setup_s=timed.start_unix - process_start_unix(),
                 memory_peak_bytes=peak, numbers=numbers,
                 tokens_per_step=ranks * rows * m["seq"],
                 flops_per_step=flagship_step_flops(m, ranks * rows, m["seq"]),
                 ranks=ranks, traced_ops=traced_steps,
                 traced_window=(traced.start_ns, traced.end_ns) if traced else None,
                 counters=counts, notes=notes)
