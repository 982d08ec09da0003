"""Meshes: binding ranks to devices for the in-graph tier.

The JAX package builds a ``jax.sharding.Mesh`` and runs collectives under
``shard_map`` over it. The port has no ``shard_map``: the ranks of a mesh
are virtual, their per-rank tensors are stacked along a leading rank axis,
and a mesh says how many ranks there are and on which device each lives.
Ranks wrap onto the devices as ``SpmdContext.device_for`` wraps them, so
on a one-card host every rank shares the card; a stacked tensor lives on
``Mesh.device``. The default devices are the CUDA cards; a CPU mesh is had
only by asking for it (``devices=[torch.device("cpu")]``).

One mesh axis is carried here; a 1-d Cartesian communicator maps onto it
(``CartComm.device_mesh``). Meshes of several axes come later (ROADMAP
Queue A #8b).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import torch

_TOPOLOGY = ("meshes of more than one axis come with a later slice of the "
             "port (ROADMAP Queue A #8b)")


def local_device_count() -> int:
    """CUDA cards of this host (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class Mesh:
    """One named axis of ``size`` ranks; ``devices[r]`` holds rank r."""

    def __init__(self, axis: str, devices: Sequence[torch.device]):
        if not devices:
            raise ValueError("a mesh needs at least one rank")
        self.axis_names = (axis,)
        self.devices = tuple(torch.device(d) for d in devices)
        self.shape = {axis: len(self.devices)}
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
    """A mesh from ``{axis: size}`` (or a shape plus names). Rank r lives on
    ``devices[r % len(devices)]``; the default devices are the CUDA cards."""
    if isinstance(axes, Mapping):
        names = tuple(axes.keys())
        shape = tuple(int(s) for s in axes.values())
    else:
        shape = tuple(int(s) for s in axes)
        names = tuple(names) if names is not None else tuple(
            f"ax{i}" for i in range(len(shape)))
    if len(shape) != 1:
        raise NotImplementedError(_TOPOLOGY)
    devices = list(devices) if devices is not None else _default_devices()
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    return Mesh(names[0], [devices[r % len(devices)] for r in range(shape[0])])


def world_mesh(axis: str = "world") -> Mesh:
    """A mesh of one rank per local card — the COMM_WORLD of the in-graph
    tier."""
    return make_mesh({axis: local_device_count()})


def comm_mesh(comm, axis: str = "comm", devices=None) -> Mesh:
    """A mesh over a host communicator's ranks, in its rank order, so that
    in-graph rank r is the communicator's rank r. Each rank lives where its
    world rank's device is (``device_for``), or, with ``devices``, on
    ``devices[world_rank % len(devices)]``. A Cartesian communicator goes
    through ``CartComm.device_mesh`` (1-d grids only)."""
    if getattr(comm, "dims", None) is not None:
        # a Cartesian communicator: its 1-d grid is the mesh; more axes raise
        return comm.device_mesh((axis,), devices=devices)
    if devices is None:
        ctx = comm.ctx
        devs = [ctx.device_for(w) for w in comm.group]
    else:
        devices = list(devices)
        devs = [devices[w % len(devices)] for w in comm.group]
    return Mesh(axis, devs)
