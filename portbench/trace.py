"""The device trace of a traced run and what the metrics read from it.

``torch.profiler`` records the card's operations (kernels, copies, sets)
over the measured window, with CUDA activity alone, so the rank threads'
host work is not slowed by recording it. The benchmark's own host spans
(``Spans``) name what the host was doing; they are taken on the monotonic
clock. One marker kernel, launched on an idle card when the profiler
starts, ties the two clocks together: its start on the device is the
moment of its launch on the host.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[int, int]
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


class Spans:
    """Host spans ``(name, start_ns, end_ns)`` on the monotonic clock, one
    list per rank (each rank thread appends to its own)."""

    def __init__(self) -> None:
        self._lists: Dict[int, list] = {}

    def mine(self, rank: int = 0) -> list:
        return self._lists.setdefault(rank, [])

    def of(self, rank: int = 0) -> list:
        return self._lists.get(rank, [])


class DeviceTrace:
    """The profiler over one window; after :meth:`stop`, ``ops``: the card's
    operations as ``(name, start_ns, end_ns)``, and ``offset_ns``, which
    moves a monotonic host time to the profiler's clock."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops: List[Tuple[str, int, int]] = []
        self.offset_ns = None
        self._mark_ns = None

    def start(self) -> None:
        import torch
        self._prof.start()
        torch.cuda.synchronize()
        self._mark_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> None:
        self._prof.stop()
        ops = device_ops(self._prof.profiler.kineto_results.events())
        marks = [a for name, a, _ in ops if MARKER in name]
        if not marks:
            raise RuntimeError(f"the device trace holds no {MARKER}: its clock "
                               "cannot be tied to the host's")
        self.offset_ns = marks[0] - self._mark_ns
        self.ops = [op for op in ops if MARKER not in op[0]]


def device_ops(events: Iterable) -> List[Tuple[str, int, int]]:
    out = []
    for e in events:
        if not str(e.device_type()).endswith("CUDA"):
            continue
        if hasattr(e, "start_ns"):
            a, d = int(e.start_ns()), int(e.duration_ns())
        else:
            a, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        out.append((e.name(), a, a + d))
    out.sort(key=lambda x: x[1])
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged, sorted, non-overlapping intervals."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def overlap_ns(xs: Sequence[Interval], ys: Sequence[Interval]) -> int:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def busy(ops: Sequence[Tuple[str, int, int]], window: Interval) -> List[Interval]:
    """The card's busy intervals inside the window."""
    return clip(union((a, b) for _, a, b in ops), *window)


def top_ops(ops: Sequence[Tuple[str, int, int]], window: Interval, k: int = 10) -> list:
    """The k device operations that took most time in the window, by name,
    in seconds."""
    by: dict = {}
    for name, a, b in ops:
        a, b = max(a, window[0]), min(b, window[1])
        if b > a:
            by[name] = by.get(name, 0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_by_span(busy_iv: Sequence[Interval], window: Interval,
                 spans: Sequence[Tuple[str, int, int]], k: int = 10) -> list:
    """The card's idle time in the window, split by the host span in which
    each idle stretch falls (``spans``: one thread's, sorted, not
    overlapping), in seconds; time outside every span is
    ``outside_spans``. The k largest."""
    gaps, cur = [], window[0]
    for a, b in busy_iv:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if window[1] > cur:
        gaps.append((cur, window[1]))
    starts = [s[1] for s in spans]
    by: dict = {}
    for a, b in gaps:
        covered = 0
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(spans) and spans[j][1] < b:
            name, sa, sb = spans[j]
            piece = min(b, sb) - max(a, sa)
            if piece > 0:
                by[name] = by.get(name, 0) + piece
                covered += piece
            j += 1
        if b - a > covered:
            by["outside_spans"] = by.get("outside_spans", 0) + (b - a - covered)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in top]


def within(busy_iv: Sequence[Interval], spans: Sequence[Interval]) -> int:
    """Device busy nanoseconds inside the given host spans."""
    return overlap_ns(busy_iv, union(spans))
