"""Expert-parallel training of Moonlight-16B-A3B's block with the port's
``moonlight_train_step`` on an in-graph ``ep`` mesh.

Traffic keys: ``mesh`` (``{"ep": n}``), ``rows`` (the global batch's
sequences, ``rows / n`` a rank), ``seq``, ``batches`` (seeded batches made
up front; the window cycles through them), ``zipf`` (the token ids' Zipf
exponent), ``lr``, ``checked_steps``.

Set-up takes the step through ``checked_steps`` steps, and the window goes
on from there with the same step function. The check compares those first
steps with the reference's (``reference.moonlight.sgd_steps``), computed
after the windows on weights and batches made again from the seed. The
reference's first step runs the experts the program chose (weighted by its
own float32 scores), so the gaps measure arithmetic. The choice is
measured on that step by three numbers: ``route_flip_share``, the share of
(token, MoE layer) pairs whose chosen experts differ from those the
reference chose on the same inputs; ``route_miss_share``, the share whose
choice the reference's scores reject by more than the two sides' scores
differ (:func:`miss_share`: 0 for any choice that is the top k of the
program's own scores plus the bias); and ``route_weight_gap``, how far the
weights the router gave stray from ``scale * s_i / sum s_chosen`` of its
own scores.

Under ``--trace 1`` the span ring is on in the profiled window, and the
program's ``model.mla`` and ``model.moe.*`` spans of the forward and its
backward, gradient sum and update phases (siblings, none inside another)
join the benchmark's spans; the window's device operations are summed by
kernel name into the counters (``device_ms``, ``device_launches``), and
those launched while a MoE span (the forward's four and each layer's
``model.moe.backward``) was open on the launching thread into
``moe_device_ms`` (``moe_backward_device_ms`` the backward's), beside the
model block's and the kernels' counts over the timed window and the
shapes the per-layer metrics need.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import statistics
import time

import torch

from .. import inputs_moonlight as inputs
from ..check import kept_leaves, train_numbers
from ..counts_moonlight import step_flops
from ..harness import (Facts, memory_peak, minus, process_start_unix,
                       release_device_memory, synchronize)
from ..reference import moonlight as ref
from ..trace import union
from .flagship import moved_share, norms

# the program spans a traced run copies: siblings, none inside another
SPANS = ("model.mla", "model.moe.route", "model.moe.dispatch", "model.moe.experts",
         "model.moe.combine", "model.backward", "model.grad_sum", "model.update")
# the spans whose launches are the MoE layers' card time, forward and backward
MOE_SPANS = ("model.moe.route", "model.moe.dispatch", "model.moe.experts",
             "model.moe.combine", "model.moe.backward")
SPAN_RING = 1 << 20


def program_cfg(ml, m: dict, dtype: torch.dtype):
    """The port's ``MoonlightConfig`` at these sizes."""
    keys = ("vocab", "d_model", "n_heads", "n_layers", "n_dense", "d_ff", "kv_rank",
            "qk_nope", "qk_rope", "v_head", "n_experts", "top_k", "d_expert", "n_shared",
            "routed_scale", "rope_base", "eps")
    return ml.MoonlightConfig(**{k: m[k] for k in keys}, dtype=dtype)


def counters() -> dict:
    """The model block's counts and the kernels' launches."""
    from tpu_mpi_torch import perfvars
    from tpu_mpi_torch.kernels import attention, fused_reduce, permute
    return {"model": perfvars.model_snapshot(),
            "fold_launches": fused_reduce.launches,
            "attention_launches": attention.launches,
            "attention_dims_launches": dict(attention.dims_launches),
            "permute_launches": dict(permute.launches)}


@contextlib.contextmanager
def recorded_routes(ml, out: list):
    """Each call of the model's router appends, on the host, its chosen
    experts, what it chose them by (the scores plus the bias, as the
    router adds them), its scores and the weights it gave."""
    real = ml.route

    def route(scores, bias, k, scale):
        idx, w = real(scores, bias, k, scale)
        out.append(tuple(x.detach().cpu() for x in (idx, scores.detach() + bias.float(),
                                                    scores, w)))
        return idx, w

    ml.route = route
    try:
        yield
    finally:
        ml.route = real


def by_sequence(program: list, rows: int, per: int) -> list:
    """The program's chosen experts, recorded by MoE layer as (n, per * T,
    k), by sequence, then layer, (T, k) each, as the reference takes them."""
    return [[got[j // per].view(per, -1, got.shape[-1])[j % per] for got in program]
            for j in range(rows)]


def flip_share(got: list, want: list) -> float:
    """The share of (token, MoE layer) pairs whose chosen sets differ
    between two lists by sequence, then layer, of (T, k) choices."""
    differ = total = 0
    for a_seq, b_seq in zip(got, want):
        for a, b in zip(a_seq, b_seq):
            a, b = a.sort(-1).values, b.to(a.device).sort(-1).values
            differ += int((a != b).any(-1).sum())
            total += a.shape[0]
    return differ / total if total else 0.0


def miss_share(idx: list, got: list, want: list) -> float:
    """The share of (token, MoE layer) pairs whose chosen experts the
    reference's keys ``want`` reject beyond what the keys' own differences
    can explain: some unchosen expert's key above a chosen one's by more
    than twice the token's largest ``|got - want|``. A choice that is the
    top k of ``got`` never is (its keys cross the reference's by at most
    that much); a choice made by anything else is, unless near a tie.
    Lists by sequence, then layer, of (T, k) choices and (T, E) keys,
    compared in float64."""
    missed = total = 0
    for i_seq, g_seq, w_seq in zip(idx, got, want):
        for i, g, w in zip(i_seq, g_seq, w_seq):
            g, w, i = g.double().cpu(), w.double().cpu(), i.cpu()
            chosen = torch.zeros(w.shape, dtype=torch.bool).scatter_(-1, i, True)
            over = (w.masked_fill(chosen, -math.inf).amax(-1)
                    - w.masked_fill(~chosen, math.inf).amin(-1))
            missed += int((over > 2 * (g - w).abs().amax(-1)).sum())
            total += i.shape[0]
    return missed / total if total else 0.0


def weight_gap(recorded: list, scale: float) -> float:
    """The largest gap, over every recorded (token, choice) of every MoE
    layer, between the weight the router gave and ``scale * s_i / sum
    s_chosen`` of its own scores taken in float64, over the latter."""
    worst = 0.0
    for idx, _, scores, w in recorded:
        picked = scores.double().gather(-1, idx)
        want = picked / picked.sum(-1, keepdim=True) * scale
        worst = max(worst, float(((w.double() - want).abs() / want).max()))
    return worst


def kineto_events(dtrace) -> list:
    """The profiler's events of the last window of ``dtrace``: the card's
    operations and the runtime calls that launched them."""
    prof = getattr(dtrace, "_prof", None)
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    return list(results.events()) if results is not None else []


def launched_in(events, spans: list, offset: int, window: tuple) -> tuple:
    """(ms, unmatched ms): the device time, clipped to ``window`` on the
    trace's clock, of the card's operations whose runtime call began on
    the host inside one of ``spans`` ((t0, t1) host ns, ``offset`` the
    trace's clock less the host's), each matched to its call by
    correlation id; and that of operations whose call the trace lacks."""
    calls, ops = {}, []
    for e in events:
        cid = int(e.correlation_id())
        if str(e.device_type()).endswith("CUDA"):
            ops.append((cid, int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns())))
        elif cid:
            calls[cid] = min(calls.get(cid, math.inf), int(e.start_ns()) - offset)
    iv = union(spans)
    starts = [a for a, _ in iv]
    inside = unmatched = 0
    for cid, a, b in ops:
        a, b = max(a, window[0]), min(b, window[1])
        if b <= a:
            continue
        t = calls.get(cid) if cid else None
        if t is None:
            unmatched += b - a
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t < iv[j][1]:
            inside += b - a
    return inside / 1e6, unmatched / 1e6


def device_sums(dtrace, window: tuple) -> tuple:
    """The device operations of the window on the trace's clock, summed by
    name (the first 120 characters): (ms by name, launches by name)."""
    ms, launches = {}, {}
    for name, a, b in dtrace.ops:
        a, b = max(a, window[0]), min(b, window[1])
        if b > a:
            key = name[:120]
            ms[key] = ms.get(key, 0.0) + (b - a) / 1e6
            launches[key] = launches.get(key, 0) + 1
    return ms, launches


def run(cell) -> Facts:
    from tpu_mpi_torch import perfvars, xla
    from tpu_mpi_torch.models import moonlight as ml
    m, t, device = ref.model_cfg(cell.config), cell.traffic, cell.device
    dtype = getattr(torch, cell.config["dtype"])
    pcfg = program_cfg(ml, m, dtype)
    rows, seq, lr = int(t["rows"]), int(t["seq"]), float(t["lr"])
    checked, pool, n = int(t["checked_steps"]), int(t["batches"]), int(t["mesh"]["ep"])
    init = inputs.weights(cell.seed, m, dtype, device)
    tokens, labels = inputs.zipf_batches(cell.seed, pool, rows, seq, m["vocab"],
                                         float(t["zipf"]), device)
    step = ml.moonlight_train_step(pcfg, xla.make_mesh(t["mesh"], devices=[device]), lr=lr)
    marks = {}
    windows = cell.windows(on_open=lambda: marks.update(counters=counters()))
    names = [k for k in init if not ref.is_bias(k)]

    params, losses, recorded = init, [], []
    for s in range(checked):
        with recorded_routes(ml, recorded) if s == 0 else contextlib.nullcontext():
            params, loss = step(params, tokens[s], labels[s])
        losses.append([float(loss)])
        if s == 0:
            grad1 = norms({k: (init[k].float() - params[k].float()) / lr for k in names})
            moved = moved_share({k: init[k] for k in names}, {k: params[k] for k in names})
    got = {"losses": losses, "grad1": [grad1],
           "change": [norms({k: params[k].float() - init[k].float() for k in names})]}
    routes, keys = (by_sequence([r[j] for r in recorded], rows, rows // n) for j in (0, 1))
    weights_gap = weight_gap(recorded, m["routed_scale"])
    del init, recorded
    clock = time.perf_counter_ns
    s, counts, mine, moe = checked, [], cell.spans.mine(), []
    for window in windows:
        synchronize(device)
        cell.trace_start(window)
        if window.traced:
            perfvars.spans_on(SPAN_RING)
        window.open()
        first = s
        while window.go_on(s - first):
            a = clock()
            params, loss = step(params, tokens[s % pool], labels[s % pool])
            if not window.traced:
                mine.append(("train_step", a, clock()))
            s += 1
        synchronize(device)
        window.close()
        counts.append(s - first)
        marks.setdefault("after", counters())
        if window.traced:
            perfvars.spans_off()
            taken = [sp for sp in perfvars.take_spans() if sp.t0_ns >= window.start_ns]
            mine.extend(sorted((sp.name, sp.t0_ns, sp.t1_ns) for sp in taken
                               if sp.name in SPANS))
            moe = [(sp.name, sp.t0_ns, sp.t1_ns) for sp in taken if sp.name in MOE_SPANS]
        cell.trace_stop(window)
    peak = memory_peak(device)
    del params, loss, tokens, labels, step
    release_device_memory()

    init = inputs.weights(cell.seed, m, dtype, device)
    tokens, labels = (x[:checked] for x in inputs.zipf_batches(
        cell.seed, pool, rows, seq, m["vocab"], float(t["zipf"]), device))
    ref_routes, ref_keys = [], []
    want = ref.sgd_steps(m, init, tokens, labels, lr=lr, ranks=n, steps=checked, store=dtype,
                         routes=ref_routes, replay=routes, keys=ref_keys)
    flips, misses = flip_share(routes, ref_routes), miss_share(routes, keys, ref_keys)
    del init, tokens, labels, ref_routes, ref_keys, keys
    release_device_memory()
    numbers = {**train_numbers(got, want), "route_flip_share": flips,
               "route_miss_share": misses, "route_weight_gap": weights_gap}
    kept = kept_leaves(want["grad"])
    med = statistics.median(want["grad1"][0][k] for k in kept)
    worst = sorted(((abs(got["grad1"][0][k] - want["grad1"][0][k])
                     / max(want["grad1"][0][k], med), k) for k in kept), reverse=True)[:3]
    timed, steps = windows[0], counts[0]
    traced = windows[1] if len(windows) > 1 else None
    count = minus(marks["after"], marks["counters"])
    count["shapes"] = {"attention": [rows * m["n_heads"], seq, m["qk_nope"] + m["qk_rope"],
                                     m["v_head"]],
                       "routed_rows": rows * seq * m["top_k"], "d_model": m["d_model"]}
    if traced is not None and cell.device_trace is not None:
        off = cell.device_trace.offset_ns
        span = (traced.start_ns + off, traced.end_ns + off)
        count["device_ms"], count["device_launches"] = device_sums(cell.device_trace, span)
        events = kineto_events(cell.device_trace)
        count["moe_device_ms"], count["unmatched_device_ms"] = launched_in(
            events, [(a, b) for _, a, b in moe], off, span)
        count["moe_backward_device_ms"] = launched_in(
            events, [(a, b) for name, a, b in moe if name == "model.moe.backward"], off,
            span)[0]
    notes = [timed.note(), f"portbench: {steps} steps in {timed.seconds_measured:.3f} s; losses "
             f"of the checked steps {got['losses']} (reference {want['losses']}); the first "
             f"step changed {moved:.4f} of the weights' elements; route flips {flips:.5f} of "
             f"(token, layer) pairs, missed {misses:.5f}, weight gap {weights_gap:.3g}; the first gradient's worst leaves "
             f"{[(k, round(g, 5)) for g, k in worst]}"]
    return Facts(attempted=steps, failed=0, ops=steps, window=(timed.start_ns, timed.end_ns),
                 setup_s=timed.start_unix - process_start_unix(),
                 memory_peak_bytes=peak, numbers=numbers,
                 tokens_per_step=rows * seq, flops_per_step=step_flops(m, rows, seq),
                 traced_ops=counts[1] if traced else 0,
                 traced_window=(traced.start_ns, traced.end_ns) if traced else None,
                 counters=count, notes=notes)
