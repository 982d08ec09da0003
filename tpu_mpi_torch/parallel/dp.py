"""Data parallelism: gradient synchronization over a ``dp`` mesh axis — the
port of ``tpu_mpi/parallel/dp.py``.

The JAX functions ``psum``/``pmean`` every leaf of a pytree inside
``shard_map``; here a tree's leaves are stacked per-rank tensors, rank
axis first (with ``mesh=``, one rank dim per mesh axis, and ``axis`` a
sub-axis or a tuple of axes), and every leaf is one ``xla.allreduce`` —
the fused fold kernel on a CUDA tensor, one launch per leaf whatever the
number of groups. Trees are nested dicts, lists and tuples of tensors, as
the port's parameter dictionaries are.
"""

from __future__ import annotations

from typing import Any, Callable

from .. import xla
from ..xla.collectives import Axis, Layout
from ..operators import SUM


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts, lists and tuples (and
    the matching leaves of ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def replicate_tree(tree: Any, n: int) -> Any:
    """Every leaf replicated to n ranks: a stride-0 (n, ...) view that is a
    leaf of autograd of its own, so the gradient of each rank's copy comes
    back stacked (n, ...) for :func:`allreduce_grads` — rather than summed
    by autograd, as a shared tensor's would be."""
    return tree_map(lambda p: p.detach().unsqueeze(0).expand(
        (n,) + tuple(p.shape)).requires_grad_(), tree)


def leaves(tree: Any) -> list:
    """The tensor leaves of a tree, in :func:`tree_map` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def unflatten(tree: Any, values: list) -> Any:
    """A tree of ``tree``'s structure holding ``values`` in leaf order."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def allreduce_grads(grads: Any, axis: Axis = "dp", mean: bool = True, *,
                    mesh: Layout = None) -> Any:
    """Sum (or average) a tree of stacked gradients across the data axis
    (or axes): every rank's row becomes its group's rank-ordered fold
    (divided by the group's size with ``mean``)."""
    def one(g):
        total = xla.allreduce(g, SUM, axis=axis, mesh=mesh)
        if not mean:
            return total
        return total / (g.shape[0] if mesh is None else xla.size(mesh, axis))
    return tree_map(one, grads)


def pmean_tree(tree: Any, axis: Axis = "dp", *, mesh: Layout = None) -> Any:
    """Average any tree of stacked values (metrics, losses) across the data
    axis (or axes)."""
    return allreduce_grads(tree, axis, mean=True, mesh=mesh)
