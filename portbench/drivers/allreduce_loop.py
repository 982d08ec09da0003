"""Closed-loop ``MPI.Allreduce`` on rank threads.

Traffic keys: ``size_bytes`` (one rank's message), ``warm`` (calls before
the window), ``samples`` and ``sample_upto`` (ops whose whole results are
kept and compared, drawn from the seed among the first ``sample_upto``).
Config keys: ``ranks``, ``dtype``, ``op``.

Every rank sends its own seeded operand and receives into a
``DeviceBuffer``; each calls again the moment its last call returns. The
check compares, bit for bit against the rank-ordered fold of the same
operands made again from the seed, every rank's result of each sampled op
and of its last op.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..check import mismatches
from ..harness import (Facts, memory_peak, minus, process_start_unix,
                       release_device_memory, synchronize)
from ..reference.fold import rank_ordered_sum


def elements(cell) -> int:
    """One rank's operand length."""
    item = torch.empty((), dtype=getattr(torch, cell.config["dtype"])).element_size()
    return int(cell.traffic["size_bytes"]) // item


def sampled(cell) -> set:
    """The op indices whose results are kept, drawn from the seed."""
    tr = cell.traffic
    pick = inputs.rng(cell.seed, inputs.STREAM_ORDER)
    return set(int(i) for i in pick.choice(int(tr["sample_upto"]),
                                           size=int(tr["samples"]), replace=False))


def run(cell) -> Facts:
    import tpu_mpi_torch as MPI
    cfg, tr, device = cell.config, cell.traffic, cell.device
    ranks = int(cfg["ranks"])
    dtype = getattr(torch, cfg["dtype"])
    op = getattr(MPI, cfg["op"])
    n, samples = elements(cell), sampled(cell)
    xs = inputs.operands(cell.seed, ranks, [n], dtype, device)[0]
    before, after = {}, {}
    windows = cell.windows(on_open=lambda: before.update(_counters()))

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        send = MPI.DeviceBuffer(xs[r], device=device)
        recv = MPI.DeviceBuffer(torch.zeros_like(xs[r]), device=device)
        for _ in range(int(tr["warm"])):
            MPI.Allreduce(send, recv, op, comm)
        spans = cell.spans.mine(r)
        clock = time.perf_counter_ns
        calls, rets, kept, counts, i = [], [], {}, [], 0
        for window in windows:
            synchronize(device)
            MPI.Barrier(comm)
            if r == 0:
                cell.trace_start(window)
            MPI.Barrier(comm)
            window.open()
            first = i
            while window.go_on(i - first):
                a = clock()
                MPI.Allreduce(send, recv, op, comm)
                b = clock()
                spans.append(("Allreduce", a, b))
                calls.append(a)
                rets.append(b)
                if i in samples:
                    kept[i] = recv.value
                i += 1
            synchronize(device)
            window.close()
            counts.append(i - first)
            MPI.Barrier(comm)
            if r == 0:
                cell.trace_stop(window)
                if not after:
                    after.update(_counters())
        last = recv.value
        MPI.Finalize()
        return {"calls": calls, "rets": rets, "kept": kept, "last": last, "counts": counts}

    out = MPI.spmd_run(body, ranks)
    peak = memory_peak(device)
    counters = minus(after, before)
    calls = np.array([o["calls"] for o in out], dtype=np.int64)
    rets = np.array([o["rets"] for o in out], dtype=np.int64)
    first_call, last_ret = calls.min(0), rets.max(0)
    timed = windows[0]
    ops = out[0]["counts"][0]
    del xs
    release_device_memory()

    # the reference: the operands made again from the seed, folded in rank order
    want = rank_ordered_sum(inputs.operands(cell.seed, ranks, [n], dtype, device)[0])
    bad_elems, bad_ops = 0, set()
    for o in out:
        for i, got in o["kept"].items():
            k = mismatches(got, want)
            bad_elems += k
            if k:
                bad_ops.add(i)
        bad_elems += mismatches(o["last"], want)
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    per_second = np.bincount((last_ret[:ops] - timed.start_ns) // 1_000_000_000).tolist()
    notes = [timed.note(), f"portbench: {ops} ops in {timed.seconds_measured:.3f} s, "
             f"{len(out[0]['kept'])} whole results checked on every rank, {nbytes} bytes "
             f"a rank; ops completed in each second {per_second}"]
    traced = windows[1] if len(windows) > 1 else None
    return Facts(attempted=ops, failed=len(bad_ops), ops=ops,
                 window=(timed.start_ns, timed.end_ns),
                 setup_s=timed.start_unix - process_start_unix(),
                 memory_peak_bytes=peak, numbers={"mismatched_elements": float(bad_elems)},
                 bytes_per_op=nbytes, ranks=ranks,
                 op_spans=list(zip(first_call.tolist(), last_ret.tolist())),
                 traced_ops=len(first_call) - ops,
                 traced_window=(traced.start_ns, traced.end_ns) if traced else None,
                 counters=counters, notes=notes)


def _counters() -> dict:
    """The program's own counts of fold-kernel launches, by route, and of
    folds that left the kernel."""
    from tpu_mpi_torch import collective
    from tpu_mpi_torch.kernels import fused_reduce
    return {"fold_launches": fused_reduce.launches,
            "fold_route_launches": dict(fused_reduce.route_launches),
            "chained_folds": collective.chained_folds}
