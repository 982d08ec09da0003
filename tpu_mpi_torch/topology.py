"""Topology — the part the port's first slice reads.

The JAX package's module of the same name holds the Cartesian
communicators, neighborhood collectives and the device-mesh bridge; those
come with their own slice of the port (ROADMAP Queue A items 7 and 8). The
collective-algorithm decision (``collective._coll_select``, ``tune.select``
and the pvar topology stamp) reads the domain map and the fleet-DB
topology key, which live here.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Domain map — the intra/inter split the hierarchical collectives run on
# ---------------------------------------------------------------------------
#
# A *domain* is a set of ranks with a fast interconnect among them (one
# host's shm segment, one ICI slice) separated from the other domains by
# a slower fabric (sockets, DCN). The two-level composite runners in
# backend.py fold inside a domain first and cross the slow fabric once
# per segment instead of once per rank. Everything here is a pure
# function of the communicator's member list plus rank-uniform inputs
# (config, the replicated rendezvous address table), so every rank of a
# communicator derives the IDENTICAL map — the property the lockstep
# selection and exploration guarantees rest on.


def domain_map(ctx, group) -> Optional[Tuple[int, ...]]:
    """Domain id per communicator position, or None when the world is
    flat. ``TPU_MPI_DOMAINS=k`` (k >= 2) partitions the communicator
    into k contiguous equal blocks — the cpu-sim override that emulates
    a multi-host split on one box. Otherwise domains come from the host
    part of the rendezvous address table (``ctx.addrs``), first
    appearance ordered; fewer than two distinct hosts means flat."""
    from . import config as _config
    n = len(group)
    if n < 2:
        return None
    k = int(_config.load().domains)
    if k >= 2:
        if k > n or n % k:
            return None
        r = n // k
        return tuple(m // r for m in range(n))
    if k == 1:
        return None            # explicit "treat as one domain" = flat
    addrs = getattr(ctx, "addrs", None) if ctx is not None else None
    if not addrs:
        return None
    try:
        hosts = [str(addrs[m]).rsplit(":", 1)[0] for m in group]
    except (IndexError, TypeError):
        return None
    ids: dict = {}
    out = []
    for h in hosts:
        if h not in ids:
            ids[h] = len(ids)
        out.append(ids[h])
    if len(ids) < 2:
        return None
    return tuple(out)


def domain_shape(dmap: Optional[Tuple[int, ...]]) -> Optional[Tuple[int, int]]:
    """``(ndomains, ranks_per_domain)`` when the map is CONTIGUOUS
    (domain ids non-decreasing along rank order) and UNIFORM (equal
    sizes), else None. The hierarchical Allreduce chains partial left
    folds across domains in rank order; only a contiguous uniform
    layout keeps that chain bit-identical to the flat star's fold, so
    anything else degrades to the flat portfolio."""
    if dmap is None:
        return None
    nd = max(dmap) + 1
    if nd < 2:
        return None
    sizes = [0] * nd
    prev = 0
    for d in dmap:
        if d < prev:
            return None        # non-contiguous: ids must be non-decreasing
        prev = d
        sizes[d] += 1
    if len(set(sizes)) != 1 or sizes[0] < 2:
        return None
    return nd, sizes[0]


def domain_count(ctx, group) -> int:
    """Number of hierarchy-usable domains for this communicator (0 when
    flat or the layout is not contiguous-uniform). This is the single
    ``domains`` signal threaded through ``_coll_select`` → ``tune``."""
    shape = domain_shape(domain_map(ctx, group))
    return shape[0] if shape is not None else 0


def topology_key(domains: int = 0, nranks: int = 0,
                 arch: Optional[str] = None) -> str:
    """Fleet-DB topology key shared by the runtime, ``tune`` sweeps and
    ``tune merge``: ``single-host/<arch>`` for flat worlds, else
    ``<D>d<R>r/<arch>`` (domain count x ranks per domain). Keys never
    contain dots so they survive both tomllib and the vendored
    mini-TOML section parser when quoted."""
    if arch is None:
        arch = os.uname().machine
    if domains < 2 or nranks < domains or nranks % domains:
        return f"single-host/{arch}"
    return f"{domains}d{nranks // domains}r/{arch}"
