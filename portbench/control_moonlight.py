"""The control and the faults that ``correct`` has to catch in the Moonlight
cell, for setting and proving its limits. The benchmark's own runs never
run this.

    python3 portbench/control_moonlight.py --workload <cell> --seeds <n>,<n>,... [--program]

prints one JSON line a seed: with ``--program``, the numbers of a short
sound run of the program (``control.program_numbers``); otherwise the
cell's numbers read from the reference computed with float8 products (the
control for bfloat16) and from the reference with each fault planted, each
against the float32 reference on the cell's first batches (which replays
the first step's choices of experts of what it is held against, as in the
driver).

``plant(fault)`` plants a fault in the program itself, for the tests that
drive a whole run with the timed path broken underneath: ``unchanged``
(the weights never move), ``half_batch`` (each rank's loss over the first
half of its tokens), ``no_exchange`` (no gradient summed over the ranks),
``altered`` (one leaf's step doubled) and ``capacity_drop`` (each rank
sends an expert at most its mean load, ``t k / E`` rows rounded up, the
first in token order, and the rest are dropped), and three faults of the
router, which the reference's replay of the program's choices hides from
the gaps: ``route_no_bias`` (the top k of the scores alone),
``route_shift`` (every ``SHIFT_EVERY``-th token of every MoE layer takes
the experts one above its choice) and ``route_bias_in_weights`` (the
weights taken from the scores plus the bias).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import inputs_moonlight as inputs  # noqa: E402
from portbench.check import train_numbers  # noqa: E402
from portbench.control import cell_files, patched, program_numbers  # noqa: E402
from portbench.drivers.moe_train import flip_share, miss_share  # noqa: E402
from portbench.reference import moonlight as ref  # noqa: E402

ROUTE_FAULTS = ("route_no_bias", "route_shift", "route_bias_in_weights")
FAULTS = ("unchanged",) + ref.FAULTS + ROUTE_FAULTS
SHIFT_EVERY = 64            # route_shift: one token in 64, 1.6 % of the pairs


def _kept(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(n, t, k) true where a row is among the first ``ceil(t k / E)`` of
    its rank's rows for its expert, in token order."""
    n, t, k = idx.shape
    cap = math.ceil(t * k / n_experts)
    onehot = torch.nn.functional.one_hot(idx, n_experts)            # (n, t, k, E)
    place = onehot.sum(2).cumsum(1).unsqueeze(2) * onehot            # 1-based, by token
    return (place.sum(-1) <= cap)


def _route_fault(real, fault: str):
    """The program's router with ``fault``."""
    def route(scores, bias, k, scale):
        if fault == "route_no_bias":
            return real(scores, torch.zeros_like(bias), k, scale)
        idx, w = real(scores, bias, k, scale)
        if fault == "route_shift":
            idx = idx.clone()
            idx[..., ::SHIFT_EVERY, :] = (idx[..., ::SHIFT_EVERY, :] + 1) % scores.shape[-1]
            return idx, ref.weigh(scores, idx, scale)
        return idx, ref.weigh(scores + bias.float(), idx, scale)
    return route


def plant(fault: str):
    """A context in which the program's Moonlight step carries ``fault``."""
    from tpu_mpi_torch.models import moonlight as ml
    if fault in ROUTE_FAULTS:
        return patched(ml, "route", _route_fault(ml.route, fault))
    if fault in ("unchanged", "altered"):
        real_build = ml.moonlight_train_step

        def build(*a, **kw):
            step = real_build(*a, **kw)

            def broken(params, tokens, labels):
                new, loss = step(params, tokens, labels)
                if fault == "unchanged":
                    return params, loss
                p, q = params[ref.ALTERED_LEAF], new[ref.ALTERED_LEAF]
                return {**new, ref.ALTERED_LEAF: (2 * q.float() - p.float()).to(p.dtype)}, loss
            return broken
        return patched(ml, "moonlight_train_step", build)
    if fault == "half_batch":
        real = ml.chunked_xent
        return patched(ml, "chunked_xent", lambda y, w, labels, rows: real(
            y[:, :y.shape[1] // 2], w, labels[:, :labels.shape[1] // 2], rows))
    if fault == "no_exchange":
        return patched(ml, "_psum", lambda x, axes, layout: x)
    real_moe = ml.moe_topk_dispatch_combine

    def dropping(tokens, idx, weights, experts, **kw):
        r = kw["routing"]
        kept = _kept(idx, r.n * r.el)
        return real_moe(tokens, idx, weights * kept, experts, **kw)
    return patched(ml, "moe_topk_dispatch_combine", dropping)


def train_readings(cell_name: str, seed: int, device, config=None, traffic=None) -> dict:
    """The cell's numbers for the float8 control and for each fault planted
    in the reference, each against the float32 reference, on one seed."""
    _, _, config, t = cell_files(cell_name, config, traffic)
    m = ref.model_cfg(config)
    store = getattr(torch, config["dtype"])
    checked = int(t["checked_steps"])
    init = inputs.weights(seed, m, store, device)
    tokens, labels = (x[:checked] for x in inputs.zipf_batches(
        seed, int(t["batches"]), int(t["rows"]), int(t["seq"]), m["vocab"], float(t["zipf"]),
        device))

    def go(routes=None, **kw):
        return ref.sgd_steps(m, init, tokens, labels, lr=float(t["lr"]),
                             ranks=int(t["mesh"]["ep"]), steps=checked, store=store,
                             routes=routes, **kw)
    # as the driver does: the float32 reference replays the first step's
    # choices of what it is held against; a fault leaves that step's
    # routing as it is, so the plain float32 reference is its replay
    chosen, own, by, own_by = [], [], [], []
    control = go(chosen, quant=ref.fp8, keys=by)
    out = {"control": {**train_numbers(control, go(own, replay=chosen, keys=own_by)),
                       "route_flip_share": flip_share(chosen, own),
                       "route_miss_share": miss_share(chosen, by, own_by)}}
    want = go()
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
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            line = {"seed": seed, "program": program_numbers(args.workload, seed, args.seconds,
                                                             device)}
        else:
            line = {"seed": seed, **train_readings(args.workload, seed, device)}
        print(json.dumps(line), flush=True)
        harness.release_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
