"""In-graph collectives on stacked per-rank tensors: the port of
``tpu_mpi/xla/collectives.py``.

Form: every collective takes the stacked per-rank tensor ``xs``, rank axis
first, ``(n, *local_shape)`` on one device, and returns the stacked
per-rank results — what the JAX function returns under
``shard_map(..., in_specs=P(axis), out_specs=P(axis))``, reshaped to
``(n, ...)``. Where the JAX function takes a replicated input (``scatter``,
``scatterv``) the input is stacked too, and the root's row is the one sent.
``axis`` names the mesh axis, as in the JAX signatures; the rank axis is
dim 0. A tuple of axes raises NotImplementedError (ROADMAP Queue A #8).
``rank``, ``size`` and ``barrier`` carry no data and take the mesh.

Lowerings:

- ``allreduce``/``reduce``: the rank-ordered left fold, which on the CPU
  mesh is what ``lax.psum``/``pmax``/``pmin`` compute, bit for bit. The
  predefined ops run the fused fold kernel
  (:mod:`tpu_mpi_torch.kernels.fused_reduce`) on a CUDA tensor; LAND, LOR
  and LXOR fold ``x != 0`` in int32 as the JAX lowering does; any other op
  is gathered and folded by the chained fold of
  ``collective._tensor_fold``, counted in ``collective.chained_folds``.
  ``approx_prod=True`` keeps the exp/log PROD.
- ``reduce_scatter``: SUM is the rank-ordered fold cut into blocks (what
  ``lax.psum_scatter`` gives on the CPU mesh); other ops allreduce and
  slice.
- ``allgather``/``gather``: the ring allgather kernel
  (:mod:`tpu_mpi_torch.kernels.ring`).
- ``bcast``: the root's row on every rank. (The JAX lowering, a one-hot
  ``psum``, also turns a -0.0 of the root into +0.0.)
- ``alltoall``: on a CUDA tensor, each rank's pieces are arranged as n
  contiguous destination blocks (``movedim``/``reshape``, as the Pallas
  wrapper's ``_to_block_tile`` arranges its layout), exchanged by the
  pairwise all-to-all kernel (:mod:`tpu_mpi_torch.kernels.permute`) and
  joined in source order along ``concat_axis``.
- ``ring_shift``, ``sendrecv``: on a CUDA tensor, the collective permute
  kernel, driven by a source table (-1 gives the zeros of an unmatched
  rank).
- the other movement and prefix functions (``allgatherv``, ``gatherv``,
  ``scatterv``, ``alltoallv``, ``scan``, ``exscan``), and ``alltoall``,
  ``ring_shift`` and ``sendrecv`` on a CPU tensor, are PyTorch indexing
  and elementwise ops.
  ``scan``/``exscan`` fold in rank order, where ``lax.associative_scan``
  associates as a tree: float prefixes may differ in the last bits.

A result that is the same on every rank (allreduce, bcast, allgatherv) is
one tensor broadcast over the rank axis: a stride-0 view, which PyTorch
refuses to write in place, as the host path shares one result among ranks.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .. import collective as _collective
from ..kernels import permute as _permute
from ..kernels import ring as _ring
from ..kernels.ring import stacked_ranks
from ..operators import LAND, LOR, LXOR, MAX, MIN, Op, PROD, SUM, as_op, nonzero
from .mesh import Mesh, _TOPOLOGY


def _check_axis(axis: Any) -> None:
    if not isinstance(axis, str):
        raise NotImplementedError(_TOPOLOGY)


def _replicate(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.unsqueeze(0).expand((n,) + tuple(x.shape))


def _fold(xs: torch.Tensor, op: Op) -> torch.Tensor:
    """The rank-ordered left fold over dim 0 (kernel or chained fold)."""
    return _collective._tensor_fold(list(xs.contiguous().unbind(0)), op)


# ---------------------------------------------------------------------------
# rank, size, barrier
# ---------------------------------------------------------------------------

def rank(mesh: Mesh, axis: str = "x") -> torch.Tensor:
    """Every rank's index along ``axis``, stacked: ``arange(n)`` (int32)."""
    _check_axis(axis)
    return torch.arange(mesh.axis_size(axis), dtype=torch.int32,
                        device=mesh.device)


def size(mesh: Mesh, axis: str = "x") -> int:
    """Ranks along ``axis``."""
    _check_axis(axis)
    return mesh.axis_size(axis)


def barrier(mesh: Mesh, axis: str = "x") -> torch.Tensor:
    """Synchronization point. The ranks of a mesh share one device and one
    stream, which already orders their work; like the JAX barrier (a psum
    of zeros) it returns a zero per rank."""
    _check_axis(axis)
    return torch.zeros(mesh.axis_size(axis), dtype=torch.int32,
                       device=mesh.device)


# ---------------------------------------------------------------------------
# Reduce family
# ---------------------------------------------------------------------------

def _prod_native(xs: torch.Tensor) -> torch.Tensor:
    """Approximate float PROD: magnitude exp(sum log|x|), sign by the parity
    of the negative count (opt-in, as in the JAX package)."""
    mag = torch.exp(_fold(torch.log(torch.abs(xs)), SUM))
    neg = _fold((xs < 0).to(torch.int32), SUM)
    return mag * (1 - 2 * (neg % 2)).to(xs.dtype)


def allreduce(xs: torch.Tensor, op: Any = SUM, *, axis: str = "x",
              approx_prod: bool = False) -> torch.Tensor:
    """Allreduce: every rank gets the rank-ordered fold of all rows."""
    _check_axis(axis)
    n = stacked_ranks(xs, "allreduce")
    op = as_op(op)
    if op is PROD and approx_prod and xs.is_floating_point():
        return _replicate(_prod_native(xs), n)
    if op in (LAND, LOR, LXOR):
        nz = nonzero(xs).to(torch.int32)
        if op is LAND:
            res = _fold(nz, MIN)
        elif op is LOR:
            res = _fold(nz, MAX)
        else:
            res = _fold(nz, SUM) % 2
        return _replicate(res.to(xs.dtype), n)
    return _replicate(_fold(xs, op), n)


def reduce(xs: torch.Tensor, op: Any = SUM, *, root: int = 0,
           axis: str = "x") -> torch.Tensor:
    """Rooted reduce: every rank computes the value (only the root's row is
    meaningful to the caller), as in the JAX package."""
    return allreduce(xs, op, axis=axis)


def _blocks(full: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Rows r = block r of ``full`` along ``dim`` (floor(size/n) each)."""
    c = full.shape[dim] // n
    return full.narrow(dim, 0, n * c).unflatten(dim, (n, c)).movedim(
        dim, 0).contiguous()


def reduce_scatter(xs: torch.Tensor, op: Any = SUM, *, axis: str = "x",
                   scatter_dimension: int = 0, tiled: bool = True) -> torch.Tensor:
    """Reduce-scatter: rank r gets block r of the fold along
    ``scatter_dimension`` (of the local shape). SUM cuts the rank-ordered
    fold (``tiled=False`` drops the scattered axis, which must be of size
    n); other ops cut the allreduce and keep the axis, as the JAX package
    does."""
    _check_axis(axis)
    n = stacked_ranks(xs, "reduce_scatter")
    op = as_op(op)
    if op is not SUM:
        return _blocks(allreduce(xs, op, axis=axis)[0], scatter_dimension, n)
    full = _fold(xs, SUM)
    width = full.shape[scatter_dimension]
    if not tiled:
        if width != n:
            raise ValueError(f"untiled reduce_scatter needs dimension "
                             f"{scatter_dimension} of size {n}, got {width}")
        return full.movedim(scatter_dimension, 0).contiguous()
    if width % n:
        raise ValueError(f"reduce_scatter: dimension {scatter_dimension} of "
                         f"size {width} does not split over {n} ranks")
    return _blocks(full, scatter_dimension, n)


def bcast(xs: torch.Tensor, *, root: int = 0, axis: str = "x") -> torch.Tensor:
    """Broadcast the root's row to every rank."""
    _check_axis(axis)
    n = stacked_ranks(xs, "bcast")
    if not 0 <= root < n:
        raise ValueError(f"bcast: root {root} outside {n} ranks")
    return _replicate(xs[root], n)


# ---------------------------------------------------------------------------
# Gather family
# ---------------------------------------------------------------------------

def allgather(xs: torch.Tensor, *, axis: str = "x",
              tiled: bool = False) -> torch.Tensor:
    """Allgather through the ring allgather kernel: (n, n, *local), or with
    ``tiled`` the rows concatenated along the local leading dim."""
    _check_axis(axis)
    n = stacked_ranks(xs, "allgather")
    if tiled and xs.dim() < 2:
        raise ValueError("tiled allgather needs a local leading dimension")
    out = _ring.ring_allgather(xs.contiguous())
    if tiled:
        return out.reshape((n, n * xs.shape[1]) + tuple(xs.shape[2:]))
    return out


def gather(xs: torch.Tensor, *, root: int = 0, axis: str = "x",
           tiled: bool = False) -> torch.Tensor:
    """Rooted gather; in-graph every rank holds the result (an allgather)."""
    return allgather(xs, axis=axis, tiled=tiled)


def allgatherv(xs: torch.Tensor, counts: Sequence[int], *,
               axis: str = "x") -> torch.Tensor:
    """Variable-count allgather: rank s contributes its first counts[s]
    local rows (zeros past its local length, as the JAX max-padding
    gives); every rank gets their concatenation in rank order."""
    _check_axis(axis)
    n = stacked_ranks(xs, "allgatherv")
    counts = [int(c) for c in counts]
    m = max(counts)
    if xs.shape[1] < m:
        pad = xs.new_zeros((n, m) + tuple(xs.shape[2:]))
        pad[:, :xs.shape[1]] = xs
        xs = pad
    return _replicate(torch.cat([xs[s, :c] for s, c in enumerate(counts)]), n)


def gatherv(xs: torch.Tensor, counts: Sequence[int], *, root: int = 0,
            axis: str = "x") -> torch.Tensor:
    """Variable-count rooted gather: the allgatherv result on every rank."""
    return allgatherv(xs, counts, axis=axis)


# ---------------------------------------------------------------------------
# Scatter family
# ---------------------------------------------------------------------------

def scatter(xs: torch.Tensor, *, root: int = 0, axis: str = "x") -> torch.Tensor:
    """Scatter the root's row in equal chunks of its leading dim: rank r
    gets chunk r."""
    _check_axis(axis)
    n = stacked_ranks(xs, "scatter")
    full = xs[root]
    chunk = full.shape[0] // n
    return full[:n * chunk].reshape((n, chunk) + tuple(full.shape[1:]))


def scatterv(xs: torch.Tensor, counts: Sequence[int], *, root: int = 0,
             axis: str = "x") -> torch.Tensor:
    """Variable-count scatter of the root's flat send buffer: every rank
    gets a max(counts) chunk whose first counts[rank] rows are its segment
    and the rest zeros."""
    _check_axis(axis)
    n = stacked_ranks(xs, "scatterv")
    counts = [int(c) for c in counts]
    full = xs[root]
    if len(counts) != n:
        raise ValueError(f"scatterv: {len(counts)} counts for {n} ranks")
    if sum(counts) > full.shape[0]:
        raise ValueError(f"scatterv: counts sum to {sum(counts)} but the "
                         f"send buffer holds {full.shape[0]}")
    out = full.new_zeros((n, max(counts)) + tuple(full.shape[1:]))
    start = 0
    for r, c in enumerate(counts):
        out[r, :c] = full[start:start + c]
        start += c
    return out


# ---------------------------------------------------------------------------
# All-to-all
# ---------------------------------------------------------------------------

def alltoall(xs: torch.Tensor, *, axis: str = "x", split_axis: int = 0,
             concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Alltoall as ``lax.all_to_all``: rank s cuts its tensor along
    ``split_axis`` into n pieces and sends piece r to rank r, which joins
    what it receives in source order along ``concat_axis`` (concatenated
    when ``tiled``; untiled, the split axis, of size n, is dropped and the
    pieces are stacked at ``concat_axis``)."""
    _check_axis(axis)
    n = stacked_ranks(xs, "alltoall")
    width = xs.shape[1 + split_axis]
    if tiled:
        if width % n:
            raise ValueError(f"alltoall: split axis of size {width} does not "
                             f"split over {n} ranks")
    elif width != n:
        raise ValueError(f"untiled alltoall needs a split axis of size {n}")
    if xs.device.type != "cpu":
        return _alltoall_blocks(xs, split_axis, concat_axis, tiled)
    if tiled:
        c = width // n
        return torch.stack([torch.cat([xs[s].narrow(split_axis, r * c, c)
                                       for s in range(n)], dim=concat_axis)
                            for r in range(n)])
    return torch.stack([torch.stack([xs[s].select(split_axis, r)
                                     for s in range(n)], dim=concat_axis)
                        for r in range(n)])


def _alltoall_blocks(xs: torch.Tensor, split_axis: int, concat_axis: int,
                     tiled: bool) -> torch.Tensor:
    """``alltoall`` through the pairwise all-to-all kernel: rank s's piece
    for rank d becomes the contiguous block (s, d), the kernel delivers it
    as block (d, s), and rank d's blocks join in source order along
    ``concat_axis``."""
    n = xs.shape[0]
    local = tuple(xs.shape[1:])
    a, c = split_axis, concat_axis
    if tiled:
        piece = local[:a] + (local[a] // n,) + local[a + 1:]
        blocks = xs.reshape((n,) + local[:a] + (n,) + piece[a:]).movedim(1 + a, 1)
    else:
        piece = local[:a] + local[a + 1:]
        blocks = xs.movedim(1 + a, 1)
    got = _permute.pairwise_alltoall(blocks.contiguous()).view((n, n) + piece)
    joined = got.movedim(1, 1 + c)
    if not tiled:
        return joined.contiguous()
    return joined.reshape((n,) + piece[:c] + (n * piece[c],) + piece[c + 1:])


def alltoallv(xs: torch.Tensor, counts: Sequence[Sequence[int]], *,
              axis: str = "x") -> torch.Tensor:
    """Variable-count all-to-all: ``counts[s][d]`` rows go from rank s to
    rank d. Rank s's local rows are its segments in destination order; rank
    d gets its segments in source order, then zeros, in a buffer of
    max_d(total received by d) rows."""
    _check_axis(axis)
    n = stacked_ranks(xs, "alltoallv")
    counts = [[int(c) for c in row] for row in counts]
    if len(counts) != n or any(len(row) != n for row in counts):
        raise ValueError(f"alltoallv: counts must be {n}x{n} "
                         f"(got {len(counts)}x{min(map(len, counts))})")
    if any(sum(row) > xs.shape[1] for row in counts):
        raise ValueError("alltoallv: a rank's send counts exceed the send "
                         f"buffer length {xs.shape[1]}")
    sdispls = np.zeros((n, n), np.int64)
    for s in range(n):
        sdispls[s, 1:] = np.cumsum(counts[s][:-1])
    totals = [sum(counts[s][d] for s in range(n)) for d in range(n)]
    out = xs.new_zeros((n, max(totals)) + tuple(xs.shape[2:]))
    for d in range(n):
        at = 0
        for s in range(n):
            c, lo = counts[s][d], int(sdispls[s, d])
            out[d, at:at + c] = xs[s, lo:lo + c]
            at += c
    return out


# ---------------------------------------------------------------------------
# Prefix reductions
# ---------------------------------------------------------------------------

def _prefixes(xs: torch.Tensor, op: Op) -> list:
    outs = [xs[0]]
    for r in range(1, xs.shape[0]):
        outs.append(op(outs[-1], xs[r]))
    return outs


def scan(xs: torch.Tensor, op: Any = SUM, *, axis: str = "x") -> torch.Tensor:
    """Inclusive prefix reduction over ranks, folded in rank order."""
    _check_axis(axis)
    stacked_ranks(xs, "scan")
    return torch.stack(_prefixes(xs, as_op(op)))


def exscan(xs: torch.Tensor, op: Any = SUM, *, axis: str = "x") -> torch.Tensor:
    """Exclusive prefix reduction; rank 0's is undefined in MPI and, as in
    the JAX package, is its own row."""
    _check_axis(axis)
    stacked_ranks(xs, "exscan")
    outs = _prefixes(xs, as_op(op))
    return torch.stack([xs[0]] + outs[:-1])


# ---------------------------------------------------------------------------
# Neighbour exchange
# ---------------------------------------------------------------------------

def ring_shift(xs: torch.Tensor, *, axis: str = "x", shift: int = 1) -> torch.Tensor:
    """Periodic ring step: rank r gets the row of rank r - shift."""
    _check_axis(axis)
    n = stacked_ranks(xs, "ring_shift")
    if xs.device.type != "cpu":
        return _permute.permute_rows(xs.contiguous(), _shift_sources(n, shift))
    return xs.roll(shift, 0)


def _shift_sources(n: int, shift: int) -> list:
    """The permute kernel's source table of a periodic shift."""
    return [(d - shift) % n for d in range(n)]


def sendrecv(xs: torch.Tensor, *, dest: Sequence[int], axis: str = "x") -> torch.Tensor:
    """Static neighbour exchange: rank i's row goes to rank ``dest[i]``; a
    rank that nobody sends to (``None`` or negative entries) gets zeros."""
    _check_axis(axis)
    n = stacked_ranks(xs, "sendrecv")
    pairs = [(i, int(d)) for i, d in enumerate(dest) if d is not None and d >= 0]
    targets = [d for _, d in pairs]
    if len(set(targets)) != len(targets) or any(d >= n for d in targets):
        raise ValueError(f"sendrecv: dest {list(dest)} is not a partial "
                         f"permutation of {n} ranks")
    if xs.device.type != "cpu":
        return _permute.permute_rows(xs.contiguous(), _pair_sources(pairs, n))
    out = torch.zeros_like(xs)
    for i, d in pairs:
        out[d] = xs[i]
    return out


def _pair_sources(pairs: Sequence[tuple], n: int) -> list:
    """The permute kernel's source table of (sender, receiver) pairs: -1
    where a rank receives nothing."""
    src = [-1] * n
    for i, d in pairs:
        src[d] = i
    return src
