"""The control and the faults that ``correct`` has to catch, for setting and
proving each cell's limits. The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds <n>,<n>,... [--seconds s] [--program]

prints one JSON line a seed: with ``--program``, the numbers of a short
sound run of the program, for the lower readings (many seeds in one
process, so set-up is paid once); otherwise, for an Allreduce cell, a
short run at the cell's own load with the reference's fold computed in
bfloat16 put in the program's place (the control for float32); for a
training cell, the cell's
numbers read from the reference computed with float8 products (the control
for bfloat16) and from the reference with each fault planted, each against
the float32 reference.

``plant(cell, fault)`` plants a fault in the program itself, for the tests
that drive a whole run with the timed path broken underneath.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness, inputs  # noqa: E402
from portbench.check import train_numbers  # noqa: E402
from portbench.drivers.flagship import model_cfg  # noqa: E402
from portbench.reference import flagship as ref  # noqa: E402
from portbench.reference.fold import rank_ordered_sum  # noqa: E402

ALLREDUCE_FAULTS = ("unchanged", "half", "no_exchange", "altered")
TRAIN_FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def cell_files(cell_name: str, config=None, traffic=None) -> tuple:
    """BENCHMARK.json, the cell's entry, its configuration and its
    traffic."""
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find(manifest["workloads"], cell_name, "workload")
    entry = harness.find(manifest["configs"], cell["config"], "config")
    config = config or harness.load_json(ROOT / entry["file"])
    traffic = traffic or harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    return manifest, cell, config, traffic


@contextlib.contextmanager
def patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _allreduce_plant(fault: str, seed: int, config: dict, traffic: dict, device):
    import tpu_mpi_torch as MPI
    real = MPI.Allreduce
    if fault == "control":
        from portbench.drivers.allreduce_loop import elements
        n = elements(harness.Cell("", config, traffic, seed, 0, device, None))
        dtype = getattr(torch, config["dtype"])
        xs = inputs.operands(seed, int(config["ranks"]), [n], dtype, device)[0]
        fold = rank_ordered_sum(xs, compute=torch.bfloat16)
        del xs

    def allreduce(send, recv, op, comm):
        r, n = MPI.Comm_rank(comm), MPI.Comm_size(comm)
        if fault == "unchanged":
            return recv
        if fault == "control":
            MPI.Barrier(comm)
            recv.value = fold
            return recv
        if fault == "no_exchange":
            MPI.Barrier(comm)
            recv.value = send.value.clone()
            return recv
        if fault == "half":
            part = send if r < n // 2 else MPI.DeviceBuffer(torch.zeros_like(send.value),
                                                            device=send.value.device)
            return real(part, recv, op, comm)
        real(send, recv, op, comm)
        recv.value = recv.value.clone()
        recv.value.view(-1)[0] += 1
        return recv

    return patched(MPI, "Allreduce", allreduce)


def _train_plant(kind: str, fault: str):
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch.models import transformer as tr
    from tpu_mpi_torch.train import DDPTrainer
    if kind == "ddp_train":
        if fault == "unchanged":
            return patched(DDPTrainer, "step", lambda self, grads: [None for _ in grads])
        if fault == "half_batch":
            real = tr._xent
            return patched(tr, "_xent", lambda logits, labels: real(
                logits[:logits.shape[0] // 2], labels[:labels.shape[0] // 2]))
        if fault == "no_exchange":
            real_init = DDPTrainer.__init__
            return patched(DDPTrainer, "__init__", lambda self, params, comm, **kw:
                           real_init(self, params, MPI.COMM_SELF, **kw))
        real_step = DDPTrainer.step

        def step(self, grads):
            return real_step(self, ((k, g * 2 if k == ref.ALTERED_LEAF else g)
                                    for k, g in grads))
        return patched(DDPTrainer, "step", step)
    if fault == "unchanged":
        real_build = tr.transformer_train_step

        def build(*a, **kw):
            step, specs = real_build(*a, **kw)
            return (lambda params, tokens, labels: (params, step(params, tokens, labels)[1]),
                    specs)
        return patched(tr, "transformer_train_step", build)
    if fault == "half_batch":
        real = tr._xent_ranked
        return patched(tr, "_xent_ranked", lambda logits, labels, ranks: real(
            logits[..., :logits.shape[-3] // 2, :, :], labels[..., :labels.shape[-2] // 2, :],
            ranks))
    if fault == "no_exchange":
        return patched(tr, "_psum", lambda x, axes, layout: x)
    real_sgd = tr._sgd

    def sgd(params, grads, lr):
        target = params["layers"][0]["w_in"]
        leaves = tr._dp.leaves(params)
        return real_sgd(params, [g * 2 if p is target else g for p, g in zip(leaves, grads)], lr)
    return patched(tr, "_sgd", sgd)


def plant(cell_name: str, fault: str, seed: int = 0, config=None, traffic=None,
          device=None):
    """A context in which the program carries ``fault`` (``ALLREDUCE_FAULTS``
    or ``TRAIN_FAULTS``, by the cell's driver; ``control`` for an Allreduce
    cell puts the bfloat16 reference fold in its place)."""
    _, _, config, traffic = cell_files(cell_name, config, traffic)
    if traffic["driver"] == "allreduce_loop":
        return _allreduce_plant(fault, seed, config, traffic, device)
    return _train_plant(traffic["driver"], fault)


def program_numbers(cell_name: str, seed: int, seconds: float, device) -> dict:
    """Every number a sound run of the cell reads, with a limit or not."""
    import importlib

    from portbench import trace
    _, _, config, traffic = cell_files(cell_name)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    cell = harness.Cell(cell_name, config, traffic, seed, seconds, device, trace.Spans())
    return driver.run(cell).numbers


def train_readings(cell_name: str, seed: int, device, config=None, traffic=None) -> dict:
    """The cell's numbers for the float8 control and for each fault planted
    in the reference, each against the float32 reference, on one seed."""
    _, _, config, t = cell_files(cell_name, config, traffic)
    m = model_cfg(config)
    store = getattr(torch, config["dtype"])
    checked = int(t["checked_steps"])
    init = inputs.flagship_weights(seed, m, store, device)
    if t["driver"] == "ddp_train":
        ranks, rows = int(t["ranks"]), int(t["rows_per_rank"])
        tokens, labels = (x[:checked] for x in inputs.token_batches(
            seed, int(t["batches"]), ranks * rows, m["seq"], m["vocab"], device))

        def go(**kw):
            return ref.ddp_steps(m, init, tokens, labels, ranks=ranks, lr=float(t["lr"]),
                                 momentum=float(t["momentum"]), steps=checked, **kw)
    else:
        tokens, labels = (x[:checked] for x in inputs.token_batches(
            seed, int(t["batches"]), int(t["rows"]), m["seq"], m["vocab"], device))

        def go(**kw):
            return ref.sgd_steps(m, init, tokens, labels, lr=float(t["lr"]),
                                 shards=int(t["mesh"]["sp"]), steps=checked, store=store, **kw)
    want = go()
    out = {"control": train_numbers(go(quant=ref.fp8), want)}
    for fault in ref.FAULTS:
        out[fault] = train_numbers(go(fault=fault), want)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    manifest, cell, config, traffic = cell_files(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            line = {"seed": seed, "program": program_numbers(args.workload, seed, args.seconds,
                                                             device)}
        elif traffic["driver"] == "allreduce_loop":
            with plant(args.workload, "control", seed, device=device):
                res, _, _ = harness.run_cell(manifest, ROOT, args.workload, seed,
                                             args.seconds, False, device)
            line = {"seed": seed, "control": {k: v["value"] for k, v in res["checks"].items()},
                    "correct": res["correct"]}
        else:
            line = {"seed": seed, **train_readings(args.workload, seed, device)}
        print(json.dumps(line), flush=True)
        harness.release_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
