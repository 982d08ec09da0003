"""The host time an ``Allreduce`` holds a rank in the front door outside
its wait for peers: the program's ``enter``, ``fold`` and ``copy`` phases
(``perfvars.frontdoor_totals``, read as differences across the timed
window under the counters' ``frontdoor`` key) over the window's rank-ops,
in microseconds. ``rendezvous``, a rank waiting for its peers, is left
out. In a card-bound window most of ``fold`` is the launch blocked on the
card's full queue, so this shows where the host blocked, not what the
front door's own work costs. Layer: front door."""


def read(v):
    fd = v.facts.counters.get("frontdoor") or {}
    rank_ops = v.facts.ops * v.facts.ranks
    if not fd.get("ops") or not rank_ops:
        return None
    return (fd["enter_ns"] + fd["fold_ns"] + fd["copy_ns"]) / rank_ops / 1e3
