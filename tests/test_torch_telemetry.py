"""``tests/test_telemetry.py`` rebuilt against the port's serve tier
(``test_torch_refport.port_module``; brokers on ``device="cpu"``), each
test under its reference name, plus the same sampled traffic through a
JAX and a port broker: the same span tree (names, lanes, parenting) and
the same replies, and the same flight-recorder notes for a lease's life.
Its analysis cases (``test_analyze_flight_cli``,
``test_chrome_schema_v2_names_lanes``, ``test_spans_to_chrome_lanes_and_args``)
read the port's ``analyze/__main__.py`` and ``analyze/timeline.py``.
"""

import importlib

import numpy as np

from test_torch_refport import adopt, port_module
from test_torch_serve import TOKEN, _drive, bounded

adopt(globals(), port_module("test_telemetry"))


def _traced(pkg):
    """Sampled traffic through one package's broker: replies, the span
    tree as (name, parent's name) pairs, and the lanes."""
    cfg = importlib.import_module(pkg + ".config")
    tracectx = importlib.import_module(pkg + ".tracectx")

    def prog(serve, b):
        with serve.attach(b.address, tenant="tr", token=TOKEN) as s:
            outs = [s.allreduce(np.linspace(-1, 1, 32, dtype=np.float32)
                                * (k + 1)).tobytes() for k in range(3)]
            outs.append(s.bcast(np.arange(4.0), root=1).tobytes())
        return outs
    import os
    os.environ["TPU_MPI_TRACE_SAMPLE"] = "1"
    cfg.load(refresh=True)
    tracectx.reset()
    try:
        outs = _drive(pkg, prog, nranks=2)
        spans = tracectx.drain()
    finally:
        os.environ.pop("TPU_MPI_TRACE_SAMPLE", None)
        cfg.load(refresh=True)
        tracectx.reset()
    by_id = {sp["span"]: sp for sp in spans}
    # which rank's lane holds a round's fold and which its rendezvous
    # is the order the ranks arrived in: compare names under parents, and
    # the set of lanes
    tree = sorted((sp["name"], by_id[sp["parent"]]["name"]
                   if sp["parent"] in by_id else None) for sp in spans)
    return outs, tree, sorted({sp["who"] for sp in spans})


def test_sampled_traffic_same_replies_and_span_tree_as_jax_broker():
    got = bounded(lambda: _traced("tpu_mpi_torch"), 60)
    want = bounded(lambda: _traced("tpu_mpi"), 60)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    assert any(n == "client:allreduce" for n, _ in got[1])


def _flight_kinds(pkg, tmp):
    import os
    cfg = importlib.import_module(pkg + ".config")
    flight = importlib.import_module(pkg + ".flight")
    os.environ["TPU_MPI_FLIGHT_RING"] = "64"
    os.environ["TPU_MPI_FLIGHT_DIR"] = str(tmp)
    cfg.load(refresh=True)
    flight.reset()
    try:
        def prog(serve, b):
            with serve.attach(b.address, tenant="fl", token=TOKEN) as s:
                s.allreduce(np.ones(4))
        _drive(pkg, prog, nranks=2)
        return [(r["kind"], r.get("tenant")) for r in
                flight._get_ring().snapshot() if r.get("tenant") == "fl"]
    finally:
        os.environ.pop("TPU_MPI_FLIGHT_RING", None)
        os.environ.pop("TPU_MPI_FLIGHT_DIR", None)
        cfg.load(refresh=True)
        flight.reset()


def test_lease_life_same_flight_notes_as_jax_broker(tmp_path):
    got = _flight_kinds("tpu_mpi_torch", tmp_path / "p")
    want = _flight_kinds("tpu_mpi", tmp_path / "j")
    assert got == want and got
