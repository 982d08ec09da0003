"""The numbers that decide ``correct``, each beside its limit.

A cell's limits live in ``workloads/<cell>.json`` with the readings they
were set from. Every number here is a gap between the program and the
reference; ``correct`` is true when each is at or under its limit. A
number that cannot be read (a missing or non-finite value) fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, the checks as ``{name: {"value", "limit"}}``): every number
    that has a limit, which it must not pass. A number the cell does not
    compare (it has no limit) is left out."""
    checks, ok = {}, True
    for name in sorted(limits):
        value, limit = numbers.get(name), limits[name]
        checks[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def mismatches(got, want) -> int:
    """Elements of ``got`` that are not bit for bit ``want`` (a NaN matches
    only a NaN); a shape or type that differs counts every element."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(int(want.numel()), 1)
    same = (got == want) | (got.isnan() & want.isnan())
    return int((~same).sum())


def kept_leaves(grad: Dict[str, float]) -> list:
    """The leaves whose first reference gradient is at least a thousandth of
    the median leaf's: the others move by rounding alone."""
    med = statistics.median(grad.values())
    return sorted(k for k, g in grad.items() if g >= 1e-3 * med)


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves: list) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    med = statistics.median(want[k] for k in leaves)
    worst = 0.0
    for k in leaves:
        if not math.isfinite(got[k]):
            return math.inf
        base = max(want[k], med)
        gap = abs(got[k] - want[k])
        worst = max(worst, gap / base if base > 0 else (math.inf if gap else 0.0))
    return worst


def train_numbers(got: dict, want: dict) -> Dict[str, float]:
    """A training cell's numbers from two records (``reference.flagship``'s
    form; the program's is built the same way): the worst relative gap of a
    step's loss and of the first step's loss alone (the later steps start
    from weights that already differ by rounding), of the first gradient's
    norm and of the change's norm, each over every rank and kept leaf."""
    losses_g, losses_w = got["losses"], want["losses"]
    if len(losses_g) != len(losses_w) or not losses_w:
        return {"loss_gap": math.inf, "loss1_gap": math.inf, "grad1_gap": math.inf,
                "change_gap": math.inf}
    gaps = []
    for row_g, row_w in zip(losses_g, losses_w):
        gap = 0.0 if len(row_g) == len(row_w) else math.inf
        for a, b in zip(row_g, row_w):
            gap = max(gap, abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
        gaps.append(gap)
    leaves = kept_leaves(want["grad"])
    out = {"loss_gap": max(gaps), "loss1_gap": gaps[0]}
    for key in ("grad1", "change"):
        gap = 0.0
        for g, w in zip(got[key], want[key]):
            gap = max(gap, worst_leaf_gap(g, w, leaves))
        out[f"{key}_gap"] = gap
    return out


