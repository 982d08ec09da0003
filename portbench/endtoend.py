"""The end-to-end metrics, each taken over all the work and all the time of
the timed window, on the host's clock. A metric named ``<quantity>.<kind>``
(``train_tokens_per_s.sp``) is the quantity's function, taken in the cells
of its own ``workloads``."""

from __future__ import annotations


def allreduce_GBps(f) -> float:
    """Bytes of one rank's message times the completed ops, over the
    window (nccl-tests' algorithm bandwidth)."""
    return f.bytes_per_op * f.ops / f.window_s / 1e9


def train_tokens_per_s(f) -> float:
    """Global tokens of every completed step over the window."""
    return f.tokens_per_step * f.ops / f.window_s


def setup_s(f) -> float:
    return f.setup_s


METRICS = {fn.__name__: fn for fn in (allreduce_GBps, train_tokens_per_s, setup_s)}


def value(name: str, facts) -> float:
    return METRICS[name.split(".")[0]](facts)
