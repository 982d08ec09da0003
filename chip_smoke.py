#!/usr/bin/env python3
"""On-card smoke check of tpu_mpi_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 is what the port targets) and ``nvcc``; it
imports torch, numpy and the port, never jax or tpu_mpi. Phases, each
fatal on failure:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the fold kernel from ``tpu_mpi_torch/csrc`` with nvcc (sm_90a);
3. kernel against its plain PyTorch version on the card, bitwise (floats
   compared as raw bits, NaN positions as masks): n in {2, 4, 5, 17}, every
   dtype and op the kernel takes, sizes 1, 127, 4097 and 2^26+3, NaN and
   signed-zero inputs for MAX/MIN; a non-contiguous operand must raise;
4. main path: ``spmd_run`` on 4 rank threads — Init, COMM_WORLD, a
   ``DeviceBuffer`` of float32[2^26] per rank from a numpy seed, repeated
   ``MPI.Allreduce(x, y, MPI.SUM, comm)`` (the repeats arm the auto-arm
   lane), ``Allreduce_init`` Start/Wait rounds, ``Reduce`` to root 0 — with
   every result bitwise equal to the plain fold, every tensor on cuda, the
   kernel's launch count rising by at least one per operation and the
   chained-fold count still;
5. times with CUDA events: the kernel's fold of 4 x float32[2^26], its
   bound, a 1 GiB ``copy_`` bandwidth control, the plain fold,
   ``torch.stack(xs).sum(0)`` as the library yardstick (timed only; the
   port never calls it), and the host-lane ``MPI.Allreduce`` per op.

It prints the card line, then the ``kernels`` JSON line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
N_MAIN = 1 << 26            # float32[2^26] = 256 MiB per rank
NRANKS = 4
ALLREDUCE_CALLS = 6         # > auto_arm_threshold (4): arms the lane
INIT_ROUNDS = 3
TIMED_ITERS = 20
WARMUP = 3
PARITY_NS = (2, 4, 5, 17)
PARITY_SIZES = (1, 127, 4097)
BIG_SIZE = (1 << 26) + 3
BIG_NS = (4, 17)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line = out.strip().splitlines()[0].strip()
    if not line:
        raise RuntimeError("nvidia-smi printed no card")
    return line


# ---------------------------------------------------------------------------
# 3. kernel against plain
# ---------------------------------------------------------------------------

def _int_view(t):
    import torch
    return {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]


def same_bits(a, b) -> bool:
    """Bitwise equality; for floats, NaN positions must match and every
    other element must match bit for bit (so +0 and -0 differ)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    keep = ~na
    return bool(torch.equal(a[keep].view(_int_view(a)),
                            b[keep].view(_int_view(b))))


def max_abs_err(a, b) -> float:
    import torch
    if not a.dtype.is_floating_point:
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
    keep = ~(torch.isnan(a) | torch.isnan(b))
    d = (a[keep].to(torch.float64) - b[keep].to(torch.float64)).abs()
    d = torch.nan_to_num(d, nan=0.0, posinf=0.0)   # inf - inf where both inf
    return float(d.max()) if d.numel() else 0.0


def operands(dtype, n: int, size: int, device, gen):
    """n seeded operands of one dtype: normal floats, integers across the
    whole range of the narrow types (so SUM and PROD wrap), 0/1 bools."""
    import torch
    if dtype.is_floating_point:
        return [torch.randn(size, generator=gen, device=device,
                            dtype=torch.float32).to(dtype) for _ in range(n)]
    if dtype == torch.bool:
        return [torch.randint(0, 2, (size,), generator=gen, device=device)
                .bool() for _ in range(n)]
    info = torch.iinfo(dtype)
    lo, hi = (info.min, info.max) if info.bits <= 16 else (-1000, 1000)
    return [torch.randint(lo, hi + 1, (size,), generator=gen, device=device,
                          dtype=torch.int64).to(dtype) for _ in range(n)]


def special_operands(dtype, n: int, size: int, device, gen):
    """Operands drawn from {NaN, -0, +0, -1, 1}: the MAX/MIN edge cases."""
    import torch
    pool = torch.tensor([float("nan"), -0.0, 0.0, -1.0, 1.0], device=device,
                        dtype=dtype)
    return [pool[torch.randint(0, 5, (size,), generator=gen, device=device)]
            for _ in range(n)]


def check_parity(fr, device, sizes=PARITY_SIZES, ns=PARITY_NS,
                 big_size=BIG_SIZE, big_ns=BIG_NS) -> dict:
    """Kernel against plain on every case; returns counts and the largest
    absolute difference seen (0.0 when every case is bitwise)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dtypes = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
              torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
              torch.bool]
    all_ops = ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR")
    cases, worst = 0, 0.0

    def one(xs, op, what):
        nonlocal cases, worst
        want = fr.fused_multi_reduce_plain(xs, op)
        got = fr.fused_multi_reduce(xs, op)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"kernel != plain: {what} "
                                 f"max_abs_err={max_abs_err(got, want)}")
        worst = max(worst, max_abs_err(got, want))
        cases += 1

    for dtype in dtypes:
        ops = [op for op in all_ops if fr.supports(op, dtype)]
        for size in sizes:
            for n in ns:
                xs = operands(dtype, n, size, device, gen)
                for op in ops:
                    one(xs, op, f"{dtype} {op} n={n} size={size}")
        for n in big_ns:
            xs = operands(dtype, n, big_size, device, gen)
            for op in ops:
                one(xs, op, f"{dtype} {op} n={n} size={big_size}")
            del xs
        if dtype.is_floating_point:
            for size in (*sizes, big_size):
                for n in ns:
                    xs = special_operands(dtype, n, size, device, gen)
                    for op in ("MAX", "MIN"):
                        one(xs, op, f"{dtype} {op} NaN/±0 n={n} size={size}")

    # what the kernel does not take raises instead of running
    x = torch.randn(2 * 4097, device=device, generator=gen)
    strided = [x[::2], x[1::2]]
    try:
        fr.fused_multi_reduce(strided, "SUM")
    except ValueError:
        pass
    else:
        raise AssertionError("a non-contiguous operand did not raise")
    return {"cases": cases, "max_abs_err": worst}


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def host_operands(n_elems: int, nranks: int) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal(n_elems, dtype=np.float32)
            for _ in range(nranks)]


def main_path(MPI, host: list, device) -> dict:
    """Drive the port through its user entry points on ``len(host)`` rank
    threads; assert every result against the plain fold, bitwise."""
    import torch
    from tpu_mpi_torch.kernels import fused_reduce as fr
    nranks = len(host)
    want = fr.fused_multi_reduce_plain(
        [torch.from_numpy(h).to(device) for h in host], "SUM")

    def on_device(t, what):
        if t.device.type != torch.device(device).type:
            raise AssertionError(f"{what} is on {t.device}, not {device}")

    def check(t, what):
        on_device(t, what)
        if not same_bits(t, want):
            raise AssertionError(f"{what} differs from the plain fold")

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(host[r], device=device)
        y = MPI.DeviceBuffer(np.zeros_like(host[r]), device=device)
        on_device(x.value, "x")
        on_device(y.value, "y")
        for i in range(ALLREDUCE_CALLS):
            MPI.Allreduce(x, y, MPI.SUM, comm)
            check(y.value, f"Allreduce call {i}")
        z = MPI.DeviceBuffer(np.zeros_like(host[r]), device=device)
        req = MPI.Allreduce_init(x, z, MPI.SUM, comm)
        slots = []
        for i in range(INIT_ROUNDS):
            MPI.Start(req)
            MPI.Wait(req)
            check(z.value, f"Allreduce_init round {i}")
            slots.append(z.value.data_ptr())
        red = MPI.Reduce(x, MPI.SUM, 0, comm)
        if r == 0:
            check(red.value, "Reduce at root")
        elif red is not None:
            raise AssertionError("Reduce returned a result off the root")
        MPI.Finalize()
        return slots

    slots = MPI.spmd_run(body, nranks, timeout=600)
    # the persistent lane writes into preallocated slots (two per rank's
    # registration) and never reuses round k's slot in round k+1
    for s in slots:
        if any(a == b for a, b in zip(s, s[1:])) or len(set(s)) > 2 * nranks:
            raise AssertionError(f"Allreduce_init slots misused: {s}")
    return {"ops": ALLREDUCE_CALLS + INIT_ROUNDS + 1}


# ---------------------------------------------------------------------------
# 5. times
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = TIMED_ITERS, warmup: int = WARMUP) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def host_lane_ms(MPI, host: list, device, iters: int = TIMED_ITERS) -> float:
    """Wall time per host-lane ``MPI.Allreduce`` on the rank threads,
    ending in a device synchronise (rank 0's clock)."""
    import torch

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(host[r], device=device)
        y = MPI.DeviceBuffer(np.zeros_like(host[r]), device=device)
        for _ in range(WARMUP + 2):
            MPI.Allreduce(x, y, MPI.SUM, comm)
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        t0 = time.perf_counter()
        for _ in range(iters):
            MPI.Allreduce(x, y, MPI.SUM, comm)
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        dt = time.perf_counter() - t0
        MPI.Finalize()
        return dt

    return max(MPI.spmd_run(body, len(host), timeout=600)) / iters * 1e3


def host_lane_profile(MPI, host: list, device, logdir: str,
                      iters: int = 10) -> dict:
    """A ``torch.profiler`` trace (``MPI.profile_trace``, held by rank 0)
    over ``iters`` host-lane Allreduce ops: the device's busy share of the
    window, from the kernel, memcpy and memset spans of the Chrome trace."""
    import torch

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(host[r], device=device)
        y = MPI.DeviceBuffer(np.zeros_like(host[r]), device=device)
        for _ in range(WARMUP + 2):
            MPI.Allreduce(x, y, MPI.SUM, comm)
        torch.cuda.synchronize()
        MPI.Barrier(comm)
        with MPI.profile_trace(logdir):
            t0 = time.perf_counter()
            for _ in range(iters):
                MPI.Allreduce(x, y, MPI.SUM, comm)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
            MPI.Barrier(comm)
        MPI.Finalize()
        return window_us

    window_us = MPI.spmd_run(body, len(host), timeout=600)[0]
    trace = max((os.path.join(logdir, f) for f in os.listdir(logdir)),
                key=os.path.getmtime)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    fold = [e for e in spans if "fused_fold_kernel" in e.get("name", "")]
    busy_us = sum(float(e["dur"]) for e in spans)
    return {"window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3,
            "fold_ms": sum(float(e["dur"]) for e in fold) / 1e3,
            "fold_spans": len(fold), "iters": iters, "trace": trace}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective
    from tpu_mpi_torch.implementations import capabilities
    from tpu_mpi_torch.kernels import fused_reduce as fr

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card {card} | torch {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    where = f"[{card}]"

    t0 = time.perf_counter()
    so = fr.build()
    fr.load_library()
    log(f"built {so.name} in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    parity = check_parity(fr, device)
    log(f"kernel == plain, bitwise, on {parity['cases']} cases "
        f"({time.perf_counter() - t0:.1f} s)")

    host = host_operands(N_MAIN, NRANKS)
    auto_hits0 = collective._plans.auto_hits
    fr.reset_launches()
    collective.chained_folds = 0
    t0 = time.perf_counter()
    path = main_path(MPI, host, device)
    launches, chained = fr.launches, collective.chained_folds
    log(f"main path: {path['ops']} collectives on {NRANKS} rank threads in "
        f"{time.perf_counter() - t0:.1f} s; kernel launches {launches}, "
        f"chained folds {chained}, auto-armed hits "
        f"{collective._plans.auto_hits - auto_hits0}")
    if launches < path["ops"]:
        raise AssertionError(f"{launches} kernel launches for {path['ops']} "
                             f"collectives")
    if chained != 0:
        raise AssertionError(f"{chained} folds left the kernel")
    if collective._plans.auto_hits == auto_hits0:
        raise AssertionError("repeated Allreduce never took the auto-armed lane")

    # times at the main path's shapes
    xs = [torch.from_numpy(h).to(device) for h in host]
    out = torch.empty_like(xs[0])
    err = max_abs_err(fr.fused_multi_reduce(xs, "SUM"),
                      fr.fused_multi_reduce_plain(xs, "SUM"))
    kern_ms = time_ms(lambda: fr.fused_multi_reduce(xs, "SUM", out=out))
    plain_ms = time_ms(lambda: fr.fused_multi_reduce_plain(xs, "SUM"))
    lib_ms = time_ms(lambda: torch.stack(xs).sum(0))
    gib = 1 << 30
    src = torch.empty(gib, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    copy_gbps = 2 * gib / (copy_ms * 1e-3) / 1e9
    del src, dst
    nbytes = (len(xs) + 1) * xs[0].numel() * xs[0].element_size()
    caps = capabilities()
    bytes_ms = nbytes / (caps["hbm_gbps"] * 1e9) * 1e3
    ops_ms = (len(xs) - 1) * xs[0].numel() / (caps["fp32_tflops"] * 1e12) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    host_ms = host_lane_ms(MPI, host, device)
    algbw = N_MAIN * 4 / (host_ms * 1e-3) / 1e9
    logdir = str(fr.BUILD_DIR / "traces")
    prof = host_lane_profile(MPI, host, device, logdir)
    log(f"fold 4 x float32[2^26]: kernel {kern_ms:.4f} ms "
        f"({nbytes / (kern_ms * 1e-3) / 1e9:.1f} GB/s), bound {bound_ms:.4f} ms "
        f"(bytes at the {caps['hbm_gbps']:.0f} GB/s spec), plain {plain_ms:.4f} ms, "
        f"torch.stack(xs).sum(0) {lib_ms:.4f} ms {where}")
    log(f"1 GiB copy_ {copy_ms:.4f} ms = {copy_gbps:.1f} GB/s read+write; "
        f"kernel reaches {nbytes / (kern_ms * 1e-3) / 1e9 / copy_gbps:.3f} of it {where}")
    log(f"host-lane MPI.Allreduce float32[2^26] x {NRANKS} ranks: "
        f"{host_ms:.4f} ms/op, algbw {algbw:.1f} GB/s {where}")
    if prof["fold_spans"]:
        log(f"profiled host lane, {prof['iters']} ops: window "
            f"{prof['window_ms']:.4f} ms, device busy {prof['busy_ms']:.4f} ms "
            f"(idle share {1 - prof['busy_ms'] / prof['window_ms']:.3f}), fold "
            f"kernel {prof['fold_ms'] / prof['fold_spans']:.4f} ms x "
            f"{prof['fold_spans']} (profiler adds its own cost) {where}")
    else:
        log(f"profiled host lane: the trace shows no fold kernel spans, "
            f"device busy share not measured ({prof['trace']})")

    kernels = {"kernels": [{
        "name": "fused_multi_reduce",
        "route": "cuda",
        "source": str(fr.SOURCE.relative_to(fr.SOURCE.parents[2])),
        "replaces": fr.REPLACES,
        "launches": launches,
        "max_abs_err": max(err, parity["max_abs_err"]),
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": lib_ms,
        "parity": "bitwise",
        "parity_cases": parity["cases"],
        "copy_gbps": copy_gbps,
        "host_lane_ms": host_ms,
        "host_lane_algbw_gbps": algbw,
    }]}
    print(card, flush=True)         # as nvidia-smi gives it: name, power limit
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
