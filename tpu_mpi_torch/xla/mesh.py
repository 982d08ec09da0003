"""Meshes: binding ranks to devices for the in-graph tier.

The JAX package builds a ``jax.sharding.Mesh`` and runs collectives under
``shard_map`` over it. The port has no ``shard_map``: the ranks of a mesh
are virtual, their per-rank tensors are stacked along leading rank dims,
and a mesh says how many ranks each axis has and on which device each
rank lives. Ranks wrap onto the devices as ``SpmdContext.device_for``
wraps them, so on a one-card host every rank shares the card; a stacked
tensor lives on ``Mesh.device``. The default devices are the CUDA cards; a
CPU mesh is had only by asking for it (``devices=[torch.device("cpu")]``).

The stacked layout: one leading rank dim per mesh axis, in the mesh's
axis order. On ``{"dp": 2, "tp": 2, "sp": 2}`` rank (i, j, k)'s tensor of
local shape S is ``xs[i, j, k]`` of the stacked ``(2, 2, 2, *S)``, as a
``PartitionSpec`` names the dims. A collective over axis ``a`` works on
that one dim and treats the others as independent groups; a one-axis mesh
keeps the single leading rank dim. Rank r in the flat (row-major) order is
the mesh position ``np.unravel_index(r, shape)``, as ``jax.sharding.Mesh``
lays out its devices (``tpu_mpi/xla/mesh.py``) and as a Cartesian
communicator numbers its grid.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Union

import torch


def local_device_count() -> int:
    """CUDA cards of this host (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class Mesh:
    """Named axes of ``shape[a]`` ranks each; ``devices[r]`` holds flat
    (row-major) rank r."""

    def __init__(self, axes: Union[str, Mapping[str, int]],
                 devices: Sequence[torch.device]):
        if isinstance(axes, str):
            axes = {axes: len(devices)}
        names = tuple(axes)
        sizes = tuple(int(s) for s in axes.values())
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} repeat a name")
        if not names or any(s < 1 for s in sizes):
            raise ValueError(f"a mesh needs axes of at least one rank, got {dict(axes)}")
        if len(devices) != math.prod(sizes):
            raise ValueError(f"mesh {dict(zip(names, sizes))} has "
                             f"{math.prod(sizes)} ranks, {len(devices)} devices given")
        self.axis_names = names
        self.devices = tuple(torch.device(d) for d in devices)
        self.shape = dict(zip(names, sizes))
        self.size = len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every rank shares, where stacked tensors live."""
        if len(set(self.devices)) != 1:
            raise NotImplementedError(
                "a mesh over several cards needs per-card collectives, "
                "which wait for a machine with more than one card")
        return self.devices[0]

    def axis_size(self, axis: str) -> int:
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        return self.shape[axis]

    def rank_dims(self, axes: Union[str, Sequence[str]]) -> tuple:
        """The stacked tensor's dims of the named axes, in the order given."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            self.axis_size(a)
        return tuple(self.axis_names.index(a) for a in axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _default_devices() -> list:
    count = local_device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')] "
                           "for a CPU mesh")
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(axes: Union[Mapping[str, int], Sequence[int]],
              names: Optional[Sequence[str]] = None, devices=None) -> Mesh:
    """A mesh from ``{axis: size}`` (or a shape plus names), of any number
    of axes. Flat rank r lives on ``devices[r % len(devices)]``; the
    default devices are the CUDA cards."""
    if isinstance(axes, Mapping):
        names = tuple(axes.keys())
        shape = tuple(int(s) for s in axes.values())
    else:
        shape = tuple(int(s) for s in axes)
        names = tuple(names) if names is not None else tuple(
            f"ax{i}" for i in range(len(shape)))
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axes {names} repeat a name")
    devices = list(devices) if devices is not None else _default_devices()
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    n = math.prod(shape)
    return Mesh(dict(zip(names, shape)), [devices[r % len(devices)] for r in range(n)])


def world_mesh(axis: str = "world") -> Mesh:
    """A mesh of one rank per local card — the COMM_WORLD of the in-graph
    tier."""
    return make_mesh({axis: local_device_count()})


def comm_mesh(comm, axis: str = "comm", devices=None) -> Mesh:
    """A mesh over a host communicator's ranks, in its rank order, so that
    in-graph rank r is the communicator's rank r. Each rank lives where its
    world rank's device is (``device_for``), or, with ``devices``, on
    ``devices[world_rank % len(devices)]``. A Cartesian communicator keeps
    its grid (``CartComm.device_mesh``): a 1-d grid is the axis ``axis``,
    an N-d grid the axes ``cart0``, ``cart1``, ... as in the JAX package."""
    dims = getattr(comm, "dims", None)
    if dims is not None:
        return comm.device_mesh((axis,) if len(dims) == 1 else None, devices=devices)
    if devices is None:
        ctx = comm.ctx
        devs = [ctx.device_for(w) for w in comm.group]
    else:
        devices = list(devices)
        devs = [devices[w % len(devices)] for w in comm.group]
    return Mesh(axis, devs)
