"""What every run shares: finding a cell's files by name, the windows the
rank threads measure together (the timed one, and under ``--trace 1`` a
profiled one after it), the result line and the checks printed beside
it.

A driver (``drivers/<name>.py``, named by the traffic file's ``driver``)
gets a :class:`Cell` and returns a :class:`Facts`. The end-to-end metrics
(``endtoend.py``) and the per-layer metrics (``metrics/<name>.py``, one
file each) are read from the facts.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from .check import verdict

HERE = Path(__file__).resolve().parent
# a --trace 1 run's profiled window, after its timed one, in seconds at most:
# the profiler slows the host, so the timed window runs without it, and a
# shorter trace is read in far less time
TRACED_SECONDS = 10.0
# top-level modules that must not be loaded in a run: JAX, its libraries and
# the JAX package the port was made from (names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_mpi")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def process_start_unix() -> float:
    """When this process started, on the Unix clock (10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    now = time.time()
    return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Window:
    """A measured window, shared by the rank threads: the first to open it
    starts the clock; for each op or step the first rank to ask decides,
    by the clock, whether all go on; each rank closes it after its last
    synchronise, and the last close ends it. ``traced``: the device
    profiler records it."""

    def __init__(self, seconds: float, on_open: Optional[Callable] = None,
                 traced: bool = False) -> None:
        self.seconds = float(seconds)
        self.traced = traced
        self._lock = threading.Lock()
        self._on_open = on_open
        self._go: Dict[int, bool] = {}
        self.start_ns: Optional[int] = None
        self.end_ns = 0
        self.start_unix = 0.0
        self.gc_ns = 0              # the interpreter's collections in the window
        self._gc_at = 0
        self._closed = False

    def open(self) -> int:
        with self._lock:
            if self.start_ns is None:
                if self._on_open is not None:
                    self._on_open()
                self.start_unix = time.time()
                self.start_ns = time.perf_counter_ns()
                self._deadline = self.start_ns + int(self.seconds * 1e9)
                gc.callbacks.append(self._gc)
                self._retries = [_alloc_retries()] * 2
            return self.start_ns

    def _gc(self, phase: str, info: dict) -> None:
        if self._closed:
            return
        if phase == "start":
            self._gc_at = time.perf_counter_ns()
        elif self._gc_at:
            self.gc_ns += time.perf_counter_ns() - self._gc_at

    def go_on(self, i: int) -> bool:
        with self._lock:
            go = self._go.get(i)
            if go is None:
                go = self._go[i] = time.perf_counter_ns() < self._deadline
            return go

    def close(self) -> None:
        now = time.perf_counter_ns()
        with self._lock:
            self.end_ns = max(self.end_ns, now)
            self._closed = True
            if self._gc in gc.callbacks:
                gc.callbacks.remove(self._gc)
            self._retries[1] = _alloc_retries()

    @property
    def seconds_measured(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def note(self) -> str:
        """The window's length, what of it the interpreter's garbage
        collections took, and the CUDA allocator's retries in it (each one
        frees cached blocks and synchronises the card)."""
        return (f"window {self.seconds_measured:.3f} s, garbage collection "
                f"{self.gc_ns / 1e9:.3f} s of it, CUDA allocator retries in it "
                f"{self._retries[1] - self._retries[0]}")


def _alloc_retries() -> int:
    import torch
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_stats().get("num_alloc_retries", 0))


@dataclasses.dataclass
class Cell:
    """What a driver is given."""
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: Any
    spans: Any                      # trace.Spans
    device_trace: Any = None        # trace.DeviceTrace under --trace 1

    def windows(self, on_open: Optional[Callable] = None) -> List[Window]:
        """The windows a run measures, in order: the timed one of
        ``seconds``, whose start ends set-up, and under ``--trace 1`` a
        profiled one of at most ``TRACED_SECONDS`` after it."""
        out = [Window(self.seconds, on_open=on_open)]
        if self.device_trace is not None:
            out.append(Window(min(self.seconds, TRACED_SECONDS), traced=True))
        return out

    def trace_start(self, window: Window) -> None:
        if window.traced:
            self.device_trace.start()

    def trace_stop(self, window: Window) -> None:
        if window.traced:
            self.device_trace.stop()


@dataclasses.dataclass
class Facts:
    """What a driver measured and checked. Times are on the monotonic
    clock; the windows and ``op_spans`` in ns."""
    attempted: int
    failed: int
    ops: int                            # completed ops or steps in the timed window
    window: tuple                       # the timed window's (start_ns, end_ns)
    setup_s: float
    memory_peak_bytes: int
    numbers: Dict[str, float]           # the numbers compared, by name
    bytes_per_op: int = 0
    tokens_per_step: int = 0
    flops_per_step: int = 0
    ranks: int = 1
    latencies_ns: Optional[list] = None
    op_spans: Optional[list] = None     # (start_ns, end_ns) of each op, all ranks
    traced_ops: int = 0                 # completed ops or steps in the profiled window
    traced_window: Optional[tuple] = None
    counters: dict = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def release_device_memory() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    import torch
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def minus(after: dict, before: dict) -> dict:
    """Counts over a window: ``after - before``, key by key, one level of
    nested dictionaries deep."""
    return {k: ({j: x - before[k].get(j, 0) for j, x in v.items()} if isinstance(v, dict)
                else v - before[k]) for k, v in after.items()}


def metric_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``; where there is no such file, that of
    the quantity the name starts with (``device_idle.sp`` is read by
    ``metrics/device_idle.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def run_cell(manifest: dict, root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device, *, config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> tuple:
    """Run one cell once. Returns (result line as a dict, lines for standard
    error, counters line or None). ``config`` and ``traffic`` stand in for
    the cell's files (tests run tiny sizes on the CPU)."""
    from . import endtoend, trace as tracing
    cell = find(manifest["workloads"], cell_name, "workload")
    cfg_entry = find(manifest["configs"], cell["config"], "config")
    config = config or load_json(root / cfg_entry["file"])
    traffic = traffic or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "workloads" / f"{cell_name}.json")["limits"]
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    spans = tracing.Spans()
    dtrace = tracing.DeviceTrace() if trace and device.type == "cuda" else None
    c = Cell(cell_name, config, traffic, seed, seconds, device, spans, dtrace)
    facts: Facts = driver.run(c)

    correct, checks = verdict(facts.numbers, limits)
    metrics, view = {}, None
    if trace:
        view = _view(facts, spans, dtrace)
        for m in manifest["per_layer"]:
            if reports(m, cell_name):
                value = metric_reader(m["name"])(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest["end_to_end"]:
            if reports(m, cell_name):
                metrics[m["name"]] = {"value": endtoend.value(m["name"], facts),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": cell["chips"],
           "memory_peak_bytes": facts.memory_peak_bytes}
    result = {"correct": correct, "attempted": facts.attempted, "failed": facts.failed,
              "metrics": metrics, "device": dev}
    if view is not None and view.has_trace:
        dev["busy_s"] = view.busy_ns / 1e9
        dev["window_s"] = view.window_ns / 1e9
        result["breakdown"] = {
            "device_ops": tracing.top_ops(dtrace.ops, view.window),
            "idle_gaps": tracing.idle_by_span(view.busy, view.window, view.rank0_spans)}
    counters = facts.counters if trace else None
    result["checks"] = checks
    err = list(facts.notes) + [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                               for k, v in checks.items()]
    return result, err, counters


def _device_kind(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


@dataclasses.dataclass
class View:
    """What a per-layer metric reads: the facts, and under a device trace
    the profiled window, its ops, the card's busy intervals and the host
    spans in it, all on the trace's clock (ns)."""
    facts: Facts
    ops: int
    has_trace: bool
    window: tuple
    busy: list
    op_spans: list
    rank0_spans: list

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    @property
    def busy_ns(self) -> int:
        return sum(b - a for a, b in self.busy)


def _view(facts: Facts, spans, dtrace) -> View:
    from . import trace as tracing
    if dtrace is None or facts.traced_window is None:
        return View(facts=facts, ops=0, has_trace=False, window=facts.window, busy=[],
                    op_spans=[], rank0_spans=[])
    off = dtrace.offset_ns
    lo, hi = facts.traced_window
    window = (lo + off, hi + off)
    return View(facts=facts, ops=facts.traced_ops, has_trace=True, window=window,
                busy=tracing.busy(dtrace.ops, window),
                op_spans=[(a + off, b + off) for a, b in facts.op_spans or [] if a >= lo],
                rank0_spans=[(n, a + off, b + off) for n, a, b in spans.of(0) if a >= lo])


def main(args, root: Path) -> int:
    import torch
    manifest = load_json(root / "BENCHMARK.json")
    cell = find(manifest["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result, err, counters = run_cell(manifest, root, args.workload, args.seed,
                                     args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; it may load none of "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return 4
    if counters is not None:
        print(json.dumps({"counters": counters}))
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
