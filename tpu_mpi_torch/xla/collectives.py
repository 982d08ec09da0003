"""In-graph collectives on stacked per-rank tensors: the port of
``tpu_mpi/xla/collectives.py``.

Form: every collective takes the stacked per-rank tensor ``xs`` on one
device and returns the stacked per-rank results — what the JAX function
returns under ``shard_map``, one leading rank dim per mesh axis. Without
``mesh=`` the tensor is ``(n, *local_shape)``, one axis of n ranks; with
``mesh=`` (a :class:`~tpu_mpi_torch.xla.mesh.Mesh`, or a ``{axis: size}``
mapping naming the leading rank dims in order) it is
``(*mesh sizes, *local_shape)``, and the collective runs over the named
axis, or over a tuple of axes, once for every group of ranks the other
axes hold (as ``shard_map`` runs it on every one of them). A tuple of axes
is one group of their ranks in the tuple's order, row-major: the order in
which ``lax.psum`` over that tuple folds on the CPU mesh (``("sp",
"dp")`` folds (sp0, dp0), (sp0, dp1), (sp1, dp0), ...), which the parity
tests measure. Where the JAX function takes a replicated input
(``scatter``, ``scatterv``) the input is stacked too, and the root's row
is the one sent. ``rank``, ``size`` and ``barrier`` carry no data and take
the mesh.

One kernel launch serves every group: the group's rank dims are brought to
the front in order, the other rank dims folded into each rank's extent, and
the kernel runs on ``(n, G * count)``. When the group's dims do not lead
already, that is one copy of the tensor, counted in ``layout_copies`` and
``layout_copy_bytes`` (and, while ``record_layout`` is a list, appended to
it as ``(shape, dtype, order)``, so a caller can time the copies).

Lowerings:

- ``allreduce``/``reduce``: the rank-ordered left fold, which on the CPU
  mesh is what ``lax.psum``/``pmax``/``pmin`` compute, bit for bit. Over a
  tuple of axes, an op the JAX package gathers and folds (PROD, the
  bitwise ops, a custom op) folds one axis at a time, as it does. The
  predefined ops run the fused fold kernel
  (:mod:`tpu_mpi_torch.kernels.fused_reduce`) on a CUDA tensor; LAND, LOR
  and LXOR fold ``x != 0`` in int32 as the JAX lowering does; any other op
  is gathered and folded by the chained fold of
  ``collective._tensor_fold``, counted in ``collective.chained_folds``.
  ``approx_prod=True`` keeps the exp/log PROD. A SUM is differentiable:
  its backward is the SUM of the cotangent over the same group, the
  transpose ``lax.psum`` has.
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
  joined in source order along ``concat_axis``. Differentiable: the
  block exchange is its own inverse, so the backward is the same kernel
  on the cotangent's blocks (the all-to-all with split and concat
  swapped, as ``lax.all_to_all`` transposes).
- ``ring_shift``, ``sendrecv``: on a CUDA tensor, the collective permute
  kernel, driven by a source table (-1 gives the zeros of an unmatched
  rank). Differentiable: the backward is the kernel with the inverse
  table, zeros for a rank nobody received from (``lax.ppermute``'s
  transpose).
- the other movement and prefix functions (``allgatherv``, ``gatherv``,
  ``scatterv``, ``alltoallv``, ``scan``, ``exscan``), and ``alltoall``,
  ``ring_shift`` and ``sendrecv`` on a CPU tensor, are PyTorch indexing
  and elementwise ops (differentiable by PyTorch's own autograd).
  ``scan``/``exscan`` fold in rank order, where ``lax.associative_scan``
  associates as a tree: float prefixes may differ in the last bits.

A result that is the same on every rank of a group (allreduce, bcast,
allgatherv) is one tensor broadcast over the group's rank dims: a stride-0
view, which PyTorch refuses to write in place, as the host path shares one
result among ranks.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .. import collective as _collective
from ..kernels import permute as _permute
from ..kernels import ring as _ring
from ..kernels.ring import stacked_ranks
from ..operators import LAND, LOR, LXOR, MAX, MIN, Op, PROD, SUM, as_op, nonzero
from .mesh import Mesh

Axis = Union[str, Sequence[str]]
Layout = Union[Mesh, Mapping[str, int], None]

# Copies that bring a group's rank dims to the front (see the module doc).
layout_copies = 0
layout_copy_bytes = 0
record_layout: Optional[list] = None
_layout_lock = threading.Lock()


def reset_layout_copies() -> None:
    global layout_copies, layout_copy_bytes
    with _layout_lock:
        layout_copies = layout_copy_bytes = 0


def _layout_shape(mesh: Layout) -> dict:
    return dict(mesh.shape) if isinstance(mesh, Mesh) else dict(mesh)


class _Group:
    """The ranks of one call: ``n`` ranks along the named axis or axes,
    ``G`` independent groups of them (the other rank dims), and how to go
    between the stacked tensor and its rows ``(n, G, *local)``."""

    def __init__(self, xs: torch.Tensor, axis: Axis, mesh: Layout, what: str):
        stacked_ranks(xs, what)
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if mesh is None:
            if len(names) != 1:
                raise ValueError(f"{what} over the axes {names} needs mesh= "
                                 f"(the stacked tensor's rank dims)")
            k, dims = 1, (0,)
        else:
            shape = _layout_shape(mesh)
            order = tuple(shape)
            k = len(order)
            if len(set(names)) != len(names) or not names:
                raise ValueError(f"{what}: axes {names} name no axis or one twice")
            for a in names:
                if a not in shape:
                    raise ValueError(f"{what}: mesh has no axis {a!r} (axes {order})")
            if tuple(xs.shape[:k]) != tuple(shape.values()):
                raise ValueError(f"{what}: stacked shape {tuple(xs.shape)} does "
                                 f"not lead with the mesh's ranks {shape}")
            dims = tuple(order.index(a) for a in names)
        self.k, self.dims = k, dims
        self.order = dims + tuple(d for d in range(k) if d not in dims)
        self.sizes = tuple(xs.shape[d] for d in self.order)
        self.n = math.prod(self.sizes[:len(dims)])
        self.G = math.prod(self.sizes[len(dims):])
        self.local = tuple(xs.shape[k:])
        moved = [d for d in self.order if xs.shape[d] > 1]
        self.moves = moved != sorted(moved)

    def rows(self, xs: torch.Tensor) -> torch.Tensor:
        """(n, G, *local), a view where the layout allows one."""
        return xs.permute(self.order + tuple(range(self.k, xs.dim()))).reshape(
            (self.n, self.G) + self.local)

    def flat(self, xs: torch.Tensor) -> torch.Tensor:
        """The kernels' contiguous (n, G * count) rows."""
        rows = self.rows(xs)
        if self.moves and xs.is_contiguous():
            _count_layout_copy(xs, self.order)
        return rows.reshape(self.n, -1).contiguous()

    def back(self, ys: torch.Tensor) -> torch.Tensor:
        """Rows (n, G, *out_local) as the stacked (*rank dims, *out_local)."""
        out_local = tuple(ys.shape[2:])
        ys = ys.reshape(self.sizes + out_local)
        inverse = tuple(int(i) for i in np.argsort(self.order))
        return ys.permute(inverse + tuple(range(self.k, ys.dim())))


def _count_layout_copy(xs: torch.Tensor, order: tuple) -> None:
    global layout_copies, layout_copy_bytes
    with _layout_lock:
        layout_copies += 1
        layout_copy_bytes += xs.numel() * xs.element_size()
        if record_layout is not None:
            record_layout.append((tuple(xs.shape), xs.dtype, order))


def _replicate(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.unsqueeze(0).expand((n,) + tuple(x.shape))


def _fold_rows(flat: torch.Tensor, op: Op) -> torch.Tensor:
    """The rank-ordered left fold over the contiguous rows (kernel or
    chained fold)."""
    return _collective._tensor_fold(list(flat.unbind(0)), op)


# ---------------------------------------------------------------------------
# rank, size, barrier
# ---------------------------------------------------------------------------

def rank(mesh: Mesh, axis: Axis = "x") -> torch.Tensor:
    """Every rank's index along ``axis`` (a tuple: the row-major index in
    the tuple's order), stacked over the mesh (int32)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    idx = torch.zeros(tuple(mesh.shape.values()), dtype=torch.int32,
                      device=mesh.device)
    for a in names:
        d = mesh.rank_dims(a)[0]
        n = mesh.axis_size(a)
        pos = torch.arange(n, dtype=torch.int32, device=mesh.device)
        idx = idx * n + pos.view((n,) + (1,) * (idx.dim() - d - 1))
    return idx


def size(mesh: Layout, axis: Axis = "x") -> int:
    """Ranks along ``axis`` (or the tuple of axes) of a mesh or a
    ``{axis: size}`` layout."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    shape = _layout_shape(mesh)
    for a in names:
        if a not in shape:
            raise ValueError(f"mesh has no axis {a!r} (axes {tuple(shape)})")
    return math.prod(shape[a] for a in names)


def barrier(mesh: Mesh, axis: Axis = "x") -> torch.Tensor:
    """Synchronization point. The ranks of a mesh share one device and one
    stream, which already orders their work; like the JAX barrier (a psum
    of zeros) it returns a zero per rank."""
    size(mesh, axis)
    return torch.zeros(tuple(mesh.shape.values()), dtype=torch.int32,
                       device=mesh.device)


# ---------------------------------------------------------------------------
# Reduce family
# ---------------------------------------------------------------------------

def _reduced(flat: torch.Tensor, op: Op, approx_prod: bool) -> torch.Tensor:
    """Every group's reduction of the (n, G * count) rows, (G * count,)."""
    if op is PROD and approx_prod and flat.is_floating_point():
        mag = torch.exp(_fold_rows(torch.log(torch.abs(flat)), SUM))
        neg = _fold_rows((flat < 0).to(torch.int32), SUM)
        return mag * (1 - 2 * (neg % 2)).to(flat.dtype)
    if op in (LAND, LOR, LXOR):
        nz = nonzero(flat).to(torch.int32)
        if op is LAND:
            res = _fold_rows(nz, MIN)
        elif op is LOR:
            res = _fold_rows(nz, MAX)
        else:
            res = _fold_rows(nz, SUM) % 2
        return res.to(flat.dtype)
    return _fold_rows(flat, op)


class _Psum(torch.autograd.Function):
    """SUM allreduce of the group's rows; backward, the SUM of the
    cotangent over the same group."""

    @staticmethod
    def forward(ctx, xs, group):
        ctx.group = group
        return _psum(xs, group)

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.group), None


def _psum(xs: torch.Tensor, group: _Group) -> torch.Tensor:
    res = _fold_rows(group.flat(xs), SUM).view((group.G,) + group.local)
    return group.back(_replicate(res, group.n))


# ops the JAX package lowers to one collective over a tuple of axes
# (psum/pmax/pmin); the others fold over each axis of the tuple in turn
_NATIVE = (SUM, MAX, MIN, LAND, LOR, LXOR)


def allreduce(xs: torch.Tensor, op: Any = SUM, *, axis: Axis = "x",
              mesh: Layout = None, approx_prod: bool = False) -> torch.Tensor:
    """Allreduce: every rank gets the rank-ordered fold of its group's
    rows."""
    group = _Group(xs, axis, mesh, "allreduce")
    op = as_op(op)
    if op is SUM:
        return _Psum.apply(xs, group)
    if not isinstance(axis, str) and len(axis) > 1 and op not in _NATIVE:
        # as the JAX package's gather-and-fold path: one axis at a time
        for a in axis:
            xs = allreduce(xs, op, axis=a, mesh=mesh)
        return xs
    res = _reduced(group.flat(xs), op, approx_prod).view((group.G,) + group.local)
    return group.back(_replicate(res, group.n))


def reduce(xs: torch.Tensor, op: Any = SUM, *, root: int = 0, axis: Axis = "x",
           mesh: Layout = None) -> torch.Tensor:
    """Rooted reduce: every rank computes the value (only the root's row is
    meaningful to the caller), as in the JAX package."""
    return allreduce(xs, op, axis=axis, mesh=mesh)


def reduce_scatter(xs: torch.Tensor, op: Any = SUM, *, axis: Axis = "x",
                   mesh: Layout = None, scatter_dimension: int = 0,
                   tiled: bool = True) -> torch.Tensor:
    """Reduce-scatter: rank r of a group gets block r of the fold along
    ``scatter_dimension`` (of the local shape). SUM cuts the rank-ordered
    fold (``tiled=False`` drops the scattered axis, which must be of size
    n); other ops cut the allreduce and keep the axis, as the JAX package
    does."""
    group = _Group(xs, axis, mesh, "reduce_scatter")
    n = group.n
    op = as_op(op)
    full = _reduced(group.flat(xs), op, False).view((group.G,) + group.local)
    dim = 1 + scatter_dimension
    width = full.shape[dim]
    if op is not SUM:
        c = width // n
        blocks = full.narrow(dim, 0, n * c).unflatten(dim, (n, c)).movedim(dim, 0)
        return group.back(blocks.contiguous())
    if not tiled:
        if width != n:
            raise ValueError(f"untiled reduce_scatter needs dimension "
                             f"{scatter_dimension} of size {n}, got {width}")
        return group.back(full.movedim(dim, 0).contiguous())
    if width % n:
        raise ValueError(f"reduce_scatter: dimension {scatter_dimension} of "
                         f"size {width} does not split over {n} ranks")
    return group.back(full.unflatten(dim, (n, width // n)).movedim(dim, 0)
                      .contiguous())


def bcast(xs: torch.Tensor, *, root: int = 0, axis: Axis = "x",
          mesh: Layout = None) -> torch.Tensor:
    """Broadcast the root's row to every rank of its group."""
    group = _Group(xs, axis, mesh, "bcast")
    if not 0 <= root < group.n:
        raise ValueError(f"bcast: root {root} outside {group.n} ranks")
    return group.back(_replicate(group.rows(xs)[root], group.n))


# ---------------------------------------------------------------------------
# Gather family
# ---------------------------------------------------------------------------

def allgather(xs: torch.Tensor, *, axis: Axis = "x", mesh: Layout = None,
              tiled: bool = False) -> torch.Tensor:
    """Allgather through the ring allgather kernel: (*rank dims, n, *local),
    or with ``tiled`` the rows concatenated along the local leading dim."""
    group = _Group(xs, axis, mesh, "allgather")
    n, G = group.n, group.G
    if tiled and not group.local:
        raise ValueError("tiled allgather needs a local leading dimension")
    out = _ring.ring_allgather(group.flat(xs)).view((n, n, G) + group.local)
    out = group.back(out.movedim(1, 2))                 # (*rank, n, *local)
    if tiled:
        k = group.k
        return out.flatten(k, k + 1)
    return out


def gather(xs: torch.Tensor, *, root: int = 0, axis: Axis = "x",
           mesh: Layout = None, tiled: bool = False) -> torch.Tensor:
    """Rooted gather; in-graph every rank holds the result (an allgather)."""
    return allgather(xs, axis=axis, mesh=mesh, tiled=tiled)


def allgatherv(xs: torch.Tensor, counts: Sequence[int], *, axis: Axis = "x",
               mesh: Layout = None) -> torch.Tensor:
    """Variable-count allgather: rank s contributes its first counts[s]
    local rows (zeros past its local length, as the JAX max-padding
    gives); every rank gets their concatenation in rank order."""
    group = _Group(xs, axis, mesh, "allgatherv")
    rows = group.rows(xs)
    counts = [int(c) for c in counts]
    m = max(counts)
    if rows.shape[2] < m:
        pad = rows.new_zeros(rows.shape[:2] + (m,) + tuple(rows.shape[3:]))
        pad[:, :, :rows.shape[2]] = rows
        rows = pad
    joined = torch.cat([rows[s, :, :c] for s, c in enumerate(counts)], dim=1)
    return group.back(_replicate(joined, group.n))


def gatherv(xs: torch.Tensor, counts: Sequence[int], *, root: int = 0,
            axis: Axis = "x", mesh: Layout = None) -> torch.Tensor:
    """Variable-count rooted gather: the allgatherv result on every rank."""
    return allgatherv(xs, counts, axis=axis, mesh=mesh)


# ---------------------------------------------------------------------------
# Scatter family
# ---------------------------------------------------------------------------

def scatter(xs: torch.Tensor, *, root: int = 0, axis: Axis = "x",
            mesh: Layout = None) -> torch.Tensor:
    """Scatter the root's row in equal chunks of its leading dim: rank r
    gets chunk r."""
    group = _Group(xs, axis, mesh, "scatter")
    n = group.n
    full = group.rows(xs)[root]                         # (G, L, ...)
    chunk = full.shape[1] // n
    cut = full[:, :n * chunk].unflatten(1, (n, chunk)).movedim(1, 0)
    return group.back(cut)


def scatterv(xs: torch.Tensor, counts: Sequence[int], *, root: int = 0,
             axis: Axis = "x", mesh: Layout = None) -> torch.Tensor:
    """Variable-count scatter of the root's flat send buffer: every rank
    gets a max(counts) chunk whose first counts[rank] rows are its segment
    and the rest zeros."""
    group = _Group(xs, axis, mesh, "scatterv")
    n = group.n
    counts = [int(c) for c in counts]
    full = group.rows(xs)[root]                         # (G, L, ...)
    if len(counts) != n:
        raise ValueError(f"scatterv: {len(counts)} counts for {n} ranks")
    if sum(counts) > full.shape[1]:
        raise ValueError(f"scatterv: counts sum to {sum(counts)} but the "
                         f"send buffer holds {full.shape[1]}")
    out = full.new_zeros((n, full.shape[0], max(counts)) + tuple(full.shape[2:]))
    start = 0
    for r, c in enumerate(counts):
        out[r, :, :c] = full[:, start:start + c]
        start += c
    return group.back(out)


# ---------------------------------------------------------------------------
# All-to-all
# ---------------------------------------------------------------------------

class _Exchange(torch.autograd.Function):
    """The pairwise all-to-all of contiguous (n_src, n_dst, ...) blocks:
    block (s, d) lands at (d, s). Its own inverse, so the backward is the
    same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, blocks):
        return _permute.pairwise_alltoall(blocks).view(blocks.shape)

    @staticmethod
    def backward(ctx, g):
        return _permute.pairwise_alltoall(g.contiguous()).view(g.shape)


def _alltoall_rows(rows: torch.Tensor, split_axis: int, concat_axis: int,
                   tiled: bool) -> torch.Tensor:
    """The kernel route on rows (n, G, *local): rank s's piece for rank d
    (of every group) becomes the contiguous block (s, d), the kernel
    delivers it as block (d, s), and rank d's blocks join in source order
    along ``concat_axis``."""
    n, G = rows.shape[:2]
    local = tuple(rows.shape[2:])
    a, c = split_axis, concat_axis
    if tiled:
        piece = local[:a] + (local[a] // n,) + local[a + 1:]
        blocks = rows.reshape((n, G) + local[:a] + (n,) + piece[a:]).movedim(2 + a, 1)
    else:
        piece = local[:a] + local[a + 1:]
        blocks = rows.movedim(2 + a, 1)
    got = _Exchange.apply(blocks.contiguous())          # (n_dst, n_src, G, *piece)
    joined = got.movedim(1, 2 + c)
    if not tiled:
        return joined.contiguous()
    return joined.reshape((n, G) + piece[:c] + (n * piece[c],) + piece[c + 1:])


def _alltoall_blocks(xs: torch.Tensor, split_axis: int, concat_axis: int,
                     tiled: bool) -> torch.Tensor:
    """``alltoall`` of a one-axis stack (n, *local) through the kernel
    route."""
    return _alltoall_rows(xs.unsqueeze(1), split_axis, concat_axis, tiled).squeeze(1)


def _alltoall_plain(rows: torch.Tensor, split_axis: int, concat_axis: int,
                    tiled: bool) -> torch.Tensor:
    n = rows.shape[0]
    a, c = 1 + split_axis, 1 + concat_axis
    if tiled:
        w = rows.shape[1 + a] // n
        return torch.stack([torch.cat([rows[s].narrow(a, r * w, w)
                                       for s in range(n)], dim=c)
                            for r in range(n)])
    return torch.stack([torch.stack([rows[s].select(a, r) for s in range(n)], dim=c)
                        for r in range(n)])


def alltoall(xs: torch.Tensor, *, axis: Axis = "x", mesh: Layout = None,
             split_axis: int = 0, concat_axis: int = 0,
             tiled: bool = True) -> torch.Tensor:
    """Alltoall as ``lax.all_to_all``: rank s cuts its tensor along
    ``split_axis`` into n pieces and sends piece r to rank r of its group,
    which joins what it receives in source order along ``concat_axis``
    (concatenated when ``tiled``; untiled, the split axis, of size n, is
    dropped and the pieces are stacked at ``concat_axis``)."""
    group = _Group(xs, axis, mesh, "alltoall")
    n = group.n
    width = group.local[split_axis]
    if tiled:
        if width % n:
            raise ValueError(f"alltoall: split axis of size {width} does not "
                             f"split over {n} ranks")
    elif width != n:
        raise ValueError(f"untiled alltoall needs a split axis of size {n}")
    rows = group.rows(xs)
    if xs.device.type != "cpu":
        if group.moves and xs.is_contiguous():
            _count_layout_copy(xs, group.order)
        return group.back(_alltoall_rows(rows, split_axis, concat_axis, tiled))
    return group.back(_alltoall_plain(rows, split_axis, concat_axis, tiled))


def alltoallv(xs: torch.Tensor, counts: Sequence[Sequence[int]], *,
              axis: Axis = "x", mesh: Layout = None) -> torch.Tensor:
    """Variable-count all-to-all: ``counts[s][d]`` rows go from rank s to
    rank d. Rank s's local rows are its segments in destination order; rank
    d gets its segments in source order, then zeros, in a buffer of
    max_d(total received by d) rows."""
    group = _Group(xs, axis, mesh, "alltoallv")
    n = group.n
    rows = group.rows(xs)
    counts = [[int(c) for c in row] for row in counts]
    if len(counts) != n or any(len(row) != n for row in counts):
        raise ValueError(f"alltoallv: counts must be {n}x{n} "
                         f"(got {len(counts)}x{min(map(len, counts))})")
    if any(sum(row) > rows.shape[2] for row in counts):
        raise ValueError("alltoallv: a rank's send counts exceed the send "
                         f"buffer length {rows.shape[2]}")
    sdispls = np.zeros((n, n), np.int64)
    for s in range(n):
        sdispls[s, 1:] = np.cumsum(counts[s][:-1])
    totals = [sum(counts[s][d] for s in range(n)) for d in range(n)]
    out = rows.new_zeros(rows.shape[:2] + (max(totals),) + tuple(rows.shape[3:]))
    for d in range(n):
        at = 0
        for s in range(n):
            c, lo = counts[s][d], int(sdispls[s, d])
            out[d, :, at:at + c] = rows[s, :, lo:lo + c]
            at += c
    return group.back(out)


# ---------------------------------------------------------------------------
# Prefix reductions
# ---------------------------------------------------------------------------

def _prefixes(rows: torch.Tensor, op: Op) -> list:
    outs = [rows[0]]
    for r in range(1, rows.shape[0]):
        outs.append(op(outs[-1], rows[r]))
    return outs


def scan(xs: torch.Tensor, op: Any = SUM, *, axis: Axis = "x",
         mesh: Layout = None) -> torch.Tensor:
    """Inclusive prefix reduction over the group's ranks, folded in rank
    order."""
    group = _Group(xs, axis, mesh, "scan")
    return group.back(torch.stack(_prefixes(group.rows(xs), as_op(op))))


def exscan(xs: torch.Tensor, op: Any = SUM, *, axis: Axis = "x",
           mesh: Layout = None) -> torch.Tensor:
    """Exclusive prefix reduction; rank 0's is undefined in MPI and, as in
    the JAX package, is its own row."""
    group = _Group(xs, axis, mesh, "exscan")
    rows = group.rows(xs)
    outs = _prefixes(rows, as_op(op))
    return group.back(torch.stack([rows[0]] + outs[:-1]))


# ---------------------------------------------------------------------------
# Neighbour exchange
# ---------------------------------------------------------------------------

def _inverse_sources(src: tuple) -> tuple:
    """The source table of the transpose: rank s gets the row rank d got
    from it, zeros if nobody did."""
    inv = [-1] * len(src)
    for d, s in enumerate(src):
        if s >= 0:
            inv[s] = d
    return tuple(inv)


class _PermuteRows(torch.autograd.Function):
    """``out[d] = flat[src[d]]`` (zeros where -1) on contiguous rows;
    backward, the same kernel with the inverse table."""

    @staticmethod
    def forward(ctx, flat, src):
        ctx.src = src
        return _permute.permute_rows(flat, src)

    @staticmethod
    def backward(ctx, g):
        return _PermuteRows.apply(g.contiguous(), _inverse_sources(ctx.src)), None


def _permuted(xs: torch.Tensor, group: _Group, src: Sequence[int],
              plain) -> torch.Tensor:
    rows = group.rows(xs)
    if xs.device.type == "cpu":
        return group.back(plain(rows))
    out = _PermuteRows.apply(group.flat(xs), tuple(src))
    return group.back(out.view(rows.shape))


def ring_shift(xs: torch.Tensor, *, axis: Axis = "x", mesh: Layout = None,
               shift: int = 1) -> torch.Tensor:
    """Periodic ring step: rank r gets the row of rank r - shift."""
    group = _Group(xs, axis, mesh, "ring_shift")
    return _permuted(xs, group, _shift_sources(group.n, shift),
                     lambda rows: rows.roll(shift, 0))


def _shift_sources(n: int, shift: int) -> list:
    """The permute kernel's source table of a periodic shift."""
    return [(d - shift) % n for d in range(n)]


def sendrecv(xs: torch.Tensor, *, dest: Sequence[int], axis: Axis = "x",
             mesh: Layout = None) -> torch.Tensor:
    """Static neighbour exchange: rank i's row goes to rank ``dest[i]``; a
    rank that nobody sends to (``None`` or negative entries) gets zeros."""
    group = _Group(xs, axis, mesh, "sendrecv")
    n = group.n
    pairs = [(i, int(d)) for i, d in enumerate(dest) if d is not None and d >= 0]
    targets = [d for _, d in pairs]
    if len(set(targets)) != len(targets) or any(d >= n for d in targets):
        raise ValueError(f"sendrecv: dest {list(dest)} is not a partial "
                         f"permutation of {n} ranks")

    def plain(rows):
        out = torch.zeros_like(rows)
        for i, d in pairs:
            out[d] = rows[i]
        return out

    return _permuted(xs, group, _pair_sources(pairs, n), plain)


def _pair_sources(pairs: Sequence[tuple], n: int) -> list:
    """The permute kernel's source table of (sender, receiver) pairs: -1
    where a rank receives nothing."""
    src = [-1] * n
    for i, d in pairs:
        src[d] = i
    return src
