"""Cartesian topology: process grids, neighbour discovery, sub-grids,
neighbourhood collectives, and the domain map.

Reference: MPI.jl src/topology.jl — Dims_create! (:9-20), Cart_create
(:30-49), Cart_rank (:60-72), Cart_get (:85-96), Cartdim_get (:106-113),
Cart_coords (:123-144), Cart_shift (:155-164), Cart_sub (:178-194).
``Neighbor_allgather``/``Neighbor_alltoall`` (MPI-3) go beyond the
reference, as in the JAX package.

Port mapping: rank order is row-major (last dim fastest), as in MPI. The
ranks are threads sharing the CUDA cards of one host, so there is no
physical torus to map a grid onto: ``Cart_create`` keeps the
communicator's order whatever ``reorder`` says (the reference's freedom
to ignore it), and ``Dims_create`` factors arithmetically.
``Cart_shift`` yields the permutation a halo exchange needs, and
:meth:`CartComm.device_mesh` bridges a grid to the in-graph tier.

The collective-algorithm decision (``collective._coll_select``,
``tune.select`` and the pvar topology stamp) reads the domain map and
the fleet-DB topology key, which live here too.
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ._runtime import PROC_NULL
from .comm import COMM_NULL, Comm, Comm_split
from . import error as _ec
from .error import MPIError


def Dims_create(nnodes: int, dims: Sequence[int]) -> list[int]:
    """Balanced factorization of nnodes over len(dims) dimensions
    (ref ``Dims_create!`` :9-20). Nonzero entries are constraints; zero
    entries are filled so the dims are as close to each other as possible
    (larger dims first), and prod(dims) == nnodes."""
    dims = [int(d) for d in dims]
    if any(d < 0 for d in dims):
        raise MPIError(f"negative entry in dims {dims}", code=_ec.ERR_DIMS)
    fixed = math.prod(d for d in dims if d > 0) if any(d > 0 for d in dims) else 1
    free = [i for i, d in enumerate(dims) if d == 0]
    if fixed <= 0 or nnodes % fixed != 0:
        raise MPIError(f"cannot partition {nnodes} nodes over fixed dims {dims}",
                       code=_ec.ERR_DIMS)
    rem = nnodes // fixed
    if not free:
        if rem != 1:
            raise MPIError(f"dims {dims} do not multiply to {nnodes}",
                           code=_ec.ERR_DIMS)
        return dims
    # Greedy balanced factorization: repeatedly take the largest factor of
    # `rem` not exceeding its k-th root.
    k = len(free)
    factors: list[int] = []
    for i in range(k, 0, -1):
        target = round(rem ** (1.0 / i))
        f = 1
        for cand in range(target, 0, -1):
            if rem % cand == 0:
                f = cand
                break
        # Prefer a slightly larger divisor when the rounded root misses.
        cand = target + 1
        while f == 1 and cand <= rem:
            if rem % cand == 0:
                f = cand
                break
            cand += 1
        factors.append(f)
        rem //= f
    factors.sort(reverse=True)
    for i, f in zip(free, factors):
        dims[i] = f
    return dims


class CartComm(Comm):
    """A communicator with an attached N-d grid (ref Cart_create :30-49)."""

    def __init__(self, group, cid, dims: Sequence[int], periods: Sequence[bool],
                 name: str = "cart"):
        super().__init__(group, cid, name=name)
        self.dims = tuple(int(d) for d in dims)
        self.periods = tuple(bool(p) for p in periods)

    # -- rank <-> coords (row-major, last dim fastest: MPI order) ------------
    def rank_of_coords(self, coords: Sequence[int]) -> int:
        r = 0
        for d, p, c in zip(self.dims, self.periods, coords):
            c = int(c)
            if c < 0 or c >= d:
                if not p:
                    raise MPIError(f"coordinate {c} out of range for non-periodic "
                                   f"dim of size {d}")
                c %= d
            r = r * d + c
        return r

    def coords_of_rank(self, rank: int) -> list[int]:
        coords = []
        r = int(rank)
        for d in reversed(self.dims):
            coords.append(r % d)
            r //= d
        return list(reversed(coords))

    def mesh_axes(self) -> dict[str, int]:
        """Axis-name → size mapping of a mesh with this grid's shape."""
        return {f"cart{i}": d for i, d in enumerate(self.dims)}

    def device_mesh(self, axis_names: Optional[Sequence[str]] = None,
                    devices=None):
        """The in-graph tier's :class:`~tpu_mpi_torch.xla.mesh.Mesh` over
        this grid, one axis per dimension (``cart0``, ``cart1``, ... unless
        ``axis_names`` are given): mesh position ``coords`` is cart rank
        ``rank_of_coords(coords)`` (row-major, as the mesh's flat ranks
        are), on its world rank's device (``device_for``) or, with
        ``devices``, on ``devices[world_rank % len(devices)]``."""
        from .xla.mesh import Mesh
        names = (tuple(axis_names) if axis_names is not None
                 else tuple(f"cart{i}" for i in range(len(self.dims))))
        if len(names) != len(self.dims):
            raise ValueError(f"{len(names)} axis names for a {len(self.dims)}-d grid")
        if devices is None:
            from .buffers import resolve_device
            resolve_device()            # the card by default; raises without CUDA
            ctx = self.ctx
            devs = [ctx.device_for(w) for w in self.group]
        else:
            devices = list(devices)
            devs = [devices[w % len(devices)] for w in self.group]
        return Mesh(dict(zip(names, self.dims)), devs)


def Cart_create(comm: Comm, *args) -> Comm:
    """``Cart_create(comm, [ndims,] dims, periods, reorder)`` — collective;
    ranks beyond prod(dims) get COMM_NULL (ref :30-49). Cart rank r is
    rank r of ``comm``: ``reorder`` is accepted and ignored, since rank
    threads sharing a card have no placement to improve."""
    if len(args) == 4:
        ndims, dims, periods, _reorder = args
        dims = list(dims)[:int(ndims)]
        periods = list(periods)[:int(ndims)]
    elif len(args) == 3:
        dims, periods, _reorder = args
        dims = [int(d) for d in np.ravel(np.asarray(dims))]
        periods = list(np.ravel(np.asarray(periods)))
    else:
        raise TypeError("Cart_create(comm, [ndims,] dims, periods, reorder)")
    dims = [int(d) for d in dims]
    periods = [bool(p) for p in periods]
    n = math.prod(dims)
    if n > comm.size():
        raise MPIError(f"grid {dims} needs {n} ranks, comm has {comm.size()}",
                       code=_ec.ERR_TOPOLOGY)
    rank = comm.rank()
    sub = Comm_split(comm, 0 if rank < n else None, rank)
    if sub is COMM_NULL:
        return COMM_NULL
    return CartComm(sub.group, sub.cid, dims, periods,
                    name=f"{comm.name}.cart{tuple(dims)}")


def Cart_rank(comm: CartComm, coords: Sequence[int]) -> int:
    """Rank at grid coordinates (ref :60-72)."""
    return comm.rank_of_coords(coords)


def Cart_coords(comm: CartComm, rank: Optional[int] = None) -> list[int]:
    """Grid coordinates of a rank (calling rank by default) (ref :123-144)."""
    return comm.coords_of_rank(comm.rank() if rank is None else rank)


def Cart_get(comm: CartComm):
    """(dims, periods, coords) of the calling rank (ref :85-96)."""
    return (list(comm.dims), [int(p) for p in comm.periods],
            comm.coords_of_rank(comm.rank()))


def Cartdim_get(comm: CartComm) -> int:
    """Number of grid dimensions (ref :106-113)."""
    return len(comm.dims)


def Cart_shift(comm: CartComm, direction: int, disp: int):
    """(source, dest) ranks for a shift along a dimension (ref :155-164).

    ``dest`` is ``disp`` steps forward, ``source`` is ``disp`` steps backward;
    off-grid neighbours of non-periodic dimensions are PROC_NULL."""
    coords = comm.coords_of_rank(comm.rank())
    d = comm.dims[direction]
    periodic = comm.periods[direction]

    def neighbor(offset: int) -> int:
        c = coords[direction] + offset
        if 0 <= c < d or periodic:
            nc = list(coords)
            nc[direction] = c % d
            return comm.rank_of_coords(nc)
        return PROC_NULL

    return neighbor(-disp), neighbor(disp)


def Cart_sub(comm: CartComm, remain_dims: Sequence) -> Comm:
    """Sub-grid keeping the dimensions flagged in remain_dims (ref :178-194).

    Ranks sharing the coordinates of the *dropped* dimensions form one
    sub-communicator."""
    remain = [bool(r) for r in remain_dims]
    if len(remain) != len(comm.dims):
        raise MPIError("remain_dims length mismatch", code=_ec.ERR_TOPOLOGY)
    coords = comm.coords_of_rank(comm.rank())
    color = 0
    for c, d, r in zip(coords, comm.dims, remain):
        if not r:
            color = color * d + c
    sub = Comm_split(comm, color, comm.rank())
    sub_dims = [d for d, r in zip(comm.dims, remain) if r]
    sub_periods = [p for p, r in zip(comm.periods, remain) if r]
    return CartComm(sub.group, sub.cid, sub_dims or [1], sub_periods or [False],
                    name=f"{comm.name}.sub")


# ---------------------------------------------------------------------------
# Neighbourhood collectives (MPI-3 MPI_Neighbor_allgather / _alltoall). The
# neighbourhood of a Cartesian rank is its 2*ndims Cart_shift neighbours in
# MPI order (per dimension: negative-displacement neighbour first), with
# PROC_NULL at non-periodic boundaries leaving the matching slot untouched
# (zeros in the allocating variant).
# ---------------------------------------------------------------------------

# Internal tag for neighbourhood exchanges, above any sane user tag space.
_NEIGHBOR_TAG = (1 << 29) + 101


def _neighbor_list(comm: CartComm) -> list[int]:
    nbrs: list[int] = []
    for d in range(len(comm.dims)):
        nbrs.extend(Cart_shift(comm, d, 1))
    return nbrs


def _neighbor_exchange(sendblocks, recvbuf, count: int, comm: CartComm,
                       template) -> Any:
    """Shared engine: sendblocks[i] goes to neighbour i; block i of the
    result comes from neighbour i. The blocks land in a (2*ndims, count)
    staging array where the template lives (a tensor on its device, or a
    host array): a CUDA payload stays on the card. PROC_NULL slots are
    zeros in the allocating variant and LEFT UNTOUCHED in a caller's
    recvbuf (the receive never happens, so pre-filled boundary values
    survive)."""
    from .buffers import clone_like, extract_array, write_range
    from .pointtopoint import Irecv, Isend, Waitall

    nbrs = _neighbor_list(comm)
    arr = extract_array(template)
    if isinstance(arr, torch.Tensor):
        rows = torch.zeros((len(nbrs), count), dtype=arr.dtype, device=arr.device)
    else:
        rows = np.zeros((len(nbrs), count), dtype=arr.dtype)
    reqs = [Irecv(rows[i], nb, _NEIGHBOR_TAG, comm)
            for i, nb in enumerate(nbrs) if nb != PROC_NULL]
    reqs += [Isend(sendblocks[i], nb, _NEIGHBOR_TAG, comm)
             for i, nb in enumerate(nbrs) if nb != PROC_NULL]
    Waitall(reqs)
    if recvbuf is None:
        return clone_like(template, rows)
    for i, nb in enumerate(nbrs):
        if nb != PROC_NULL:
            write_range(recvbuf, i * count, rows[i])
    return recvbuf


def _require_cart(comm: Comm, what: str) -> None:
    if not isinstance(comm, CartComm):
        raise MPIError(f"{what} requires a Cartesian communicator",
                       code=_ec.ERR_TOPOLOGY)


def Neighbor_allgather(*args) -> Any:
    """``Neighbor_allgather(send, [recv,] comm)`` — every rank sends its
    whole buffer to each Cartesian neighbour and receives each neighbour's
    buffer into slot i of the (2*ndims, count) result (MPI-3
    MPI_Neighbor_allgather; neighbour order per :func:`Cart_shift`)."""
    if len(args) == 2:
        sendbuf, comm = args
        recvbuf = None
    elif len(args) == 3:
        sendbuf, recvbuf, comm = args
    else:
        raise TypeError("Neighbor_allgather(send, [recv,] comm)")
    _require_cart(comm, "Neighbor_allgather")
    from .buffers import element_count
    nbrs = _neighbor_list(comm)
    return _neighbor_exchange([sendbuf] * len(nbrs), recvbuf,
                              element_count(sendbuf), comm, sendbuf)


def Neighbor_alltoall(*args) -> Any:
    """``Neighbor_alltoall(send, [recv,] count, comm)`` — block i of the
    send buffer goes to neighbour i; block i of the result arrives from
    neighbour i (MPI-3 MPI_Neighbor_alltoall). ``send`` holds 2*ndims
    blocks of ``count`` elements in neighbour order."""
    if len(args) == 3:
        sendbuf, count, comm = args
        recvbuf = None
    elif len(args) == 4:
        sendbuf, recvbuf, count, comm = args
    else:
        raise TypeError("Neighbor_alltoall(send, [recv,] count, comm)")
    _require_cart(comm, "Neighbor_alltoall")
    from .buffers import assert_minlength, to_wire
    count = int(count)
    n = len(_neighbor_list(comm))
    assert_minlength(sendbuf, n * count)   # the package-wide bounds guard
    flat = to_wire(sendbuf, n * count).reshape(n, count)
    return _neighbor_exchange(list(flat), recvbuf, count, comm, sendbuf)


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
