"""The kernel layer's one table of launch counts (``kernels._build.counts``):
what ``perfvars.kernels_snapshot()`` reports, the module names the
benchmark's drivers read, and the one reset."""

from __future__ import annotations

import sys
import threading

import pytest
import torch

from tpu_mpi_torch import collective, perfvars, xla
from tpu_mpi_torch.kernels import _build, attention, fused_reduce, permute, ring
from tpu_mpi_torch.kernels._build import counts
from tpu_mpi_torch.operators import as_op

# The kernels block's keys and value types, in its order.
KEYS = {"builds": dict, "build_ns": dict, "loads": dict, "load_ns": dict,
        "fold_launches": int, "fold_route_launches": dict,
        "attention_launches": int, "attention_route_launches": dict,
        "attention_dims_launches": dict, "attention_backward_launches": int,
        "attention_backward_dims_launches": dict,
        "ring_launches": dict, "ring_route_launches": dict, "callable_rings": int,
        "permute_launches": dict,
        "ddp_pack_launches": int, "ddp_update_launches": int, "ddp_pack_copies": int,
        "chained_folds": int, "layout_copies": int, "layout_copy_bytes": int}
LIBRARY_KEYS = ("builds", "build_ns", "loads", "load_ns")

# The module names portbench/drivers read: (module, name, kernels-block key).
VIEWS = [(fused_reduce, "launches", "fold_launches"),
         (fused_reduce, "route_launches", "fold_route_launches"),
         (attention, "launches", "attention_launches"),
         (attention, "route_launches", "attention_route_launches"),
         (attention, "dims_launches", "attention_dims_launches"),
         (permute, "launches", "permute_launches"),
         (collective, "chained_folds", "chained_folds")]


def _counted_work(monkeypatch) -> None:
    """Move every count from zero: a callable ring, a chained fold and a
    grouped call that copies its layout run on the CPU; a fold launch goes
    through the wrapper's counting with the launch itself stubbed; the
    card-only attention, permute and DDP launches are added as their
    wrappers add them."""
    counts.reset()
    add = lambda a, b: a + b                                  # noqa: E731
    ring.ring_allreduce(torch.arange(8.0).reshape(2, 4), add)
    collective._tensor_fold([torch.ones(4), torch.ones(4)], as_op(add))
    xla.allreduce(torch.randn(2, 2, 2, 5), axis="sp", mesh={"dp": 2, "tp": 2, "sp": 2})
    monkeypatch.setattr(fused_reduce.LIBRARY, "fn", lambda name: name)
    monkeypatch.setattr(_build, "call", lambda *args: None)
    fused_reduce._launch([torch.ones(4), torch.ones(4)], "SUM", None, "direct")
    counts.add_many(("attention_route_launches", "sm90", 2),
                    ("attention_dims_launches", "192/128", 2))
    counts.add("attention_backward_dims_launches", "64/64", 3)
    counts.add_many(("ring_launches", "ring_reduce_scatter", 1),
                    ("ring_route_launches", "staged", 1))
    counts.add("permute_launches", "pairwise_alltoall", 4)
    for name in ("ddp_pack_launches", "ddp_update_launches", "ddp_pack_copies"):
        counts.add(name)


@pytest.mark.parametrize("module,name,key", VIEWS,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{n}" for m, n, _ in VIEWS])
def test_driver_names_read_the_table(module, name, key, monkeypatch):
    try:
        _counted_work(monkeypatch)
        value = getattr(module, name)
        assert type(value) is KEYS[key]
        assert value == perfvars.kernels_snapshot()[key]
        assert (sum(value.values()) if isinstance(value, dict) else value) > 0
    finally:
        counts.reset()


def test_no_other_name_is_served():
    for module, name in [(attention, "backward_launches"), (ring, "launches"),
                         (fused_reduce, "reset_launches"), (collective, "layout_copies")]:
        assert not hasattr(module, name)


def test_one_reset_zeroes_every_count(monkeypatch):
    _counted_work(monkeypatch)
    snap = perfvars.kernels_snapshot()
    assert list(snap) == list(KEYS)
    assert {key: type(value) for key, value in snap.items()} == KEYS
    assert snap["fold_launches"] == snap["fold_route_launches"]["direct"] == 1
    assert (snap["callable_rings"], snap["chained_folds"], snap["layout_copies"]) == (1, 1, 1)
    assert snap["layout_copy_bytes"] == 2 * 2 * 2 * 5 * 4
    assert snap["attention_launches"] == 2 and snap["attention_backward_launches"] == 3
    counts.reset()
    after = perfvars.kernels_snapshot()
    assert list(after) == list(KEYS)
    for key, value in after.items():
        if key not in LIBRARY_KEYS:
            assert set(value.values() if isinstance(value, dict) else [value]) <= {0}, key
    assert after["attention_dims_launches"] == after["attention_backward_dims_launches"] == {}
    assert {key: after[key] for key in LIBRARY_KEYS} == {key: snap[key] for key in LIBRARY_KEYS}


def test_add_many_moves_its_counts_together():
    """A reader never sees one count of an ``add_many`` moved and not the other."""
    counts.reset()
    seen = []

    def read():
        for _ in range(20000):
            snap = counts.snapshot()
            seen.append((snap["layout_copies"], snap["layout_copy_bytes"],
                         snap["ring_launches"]["ring_reduce_scatter"],
                         snap["ring_route_launches"]["direct"]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)            # switch threads often
    reader = threading.Thread(target=read)
    reader.start()
    try:
        for _ in range(20000):
            counts.add_many(("layout_copies", None, 1), ("layout_copy_bytes", None, 8))
            counts.add_many(("ring_launches", "ring_reduce_scatter", 1),
                            ("ring_route_launches", "direct", 1))
        reader.join()
        assert all(nbytes == 8 * copies and scatters == direct
                   for copies, nbytes, scatters, direct in seen)
        assert seen and counts["layout_copy_bytes"] == 8 * 20000
    finally:
        sys.setswitchinterval(interval)
        counts.reset()


def test_every_library_is_listed_whichever_modules_were_imported():
    """The libraries' maps list every source in csrc, so their keys do not
    depend on which kernel modules a process imported."""
    import tpu_mpi_torch.kernels.ddp_step  # noqa: F401  every kernel module now
    own = {lib.name: lib.source for lib in _build.Library.instances
           if lib.source.parent == _build.CSRC}
    assert all(source.stem == name for name, source in own.items())
    assert set(own) == set(_build.SOURCES)
    snap = perfvars.kernels_snapshot()
    for key in LIBRARY_KEYS:
        assert set(_build.SOURCES) <= set(snap[key])
