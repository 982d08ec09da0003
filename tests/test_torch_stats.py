"""The port's ``stats`` against the JAX package's: the same pvar dumps and
broker snapshots through both modules give the same report text, the same
JSON record and the same Prometheus exposition, bit for bit.

The dumps come from one SPMD job per package (the cases of
``tests/test_perfvars.py``'s ``test_stats_cli``: Allreduces, a Barrier,
persistent and pipelined rounds, pvars on), and each package's dumps go
through both packages' ``aggregate``/``render``. Broker snapshots (the
``STATS`` reply of a JAX broker and of a port broker after the same
traffic) go through both ``to_prometheus``/``parse_prometheus``; the
watch and partial-record cases of ``tests/test_telemetry.py`` through both
``render_watch``/``watch_fleet``/``aggregate``.
"""

import io
import json
import os
import re

import numpy as np
import pytest

import tpu_mpi as JMPI
import tpu_mpi.testing  # noqa: F401
from tpu_mpi import perfvars as jperfvars
from tpu_mpi import stats as jstats

import tpu_mpi_torch as MPI
from tpu_mpi_torch import perfvars as tperfvars
from tpu_mpi_torch import stats as tstats


def _job(M, perfvars, tmp, device=False):
    def body():
        comm = M.COMM_WORLD
        r = comm.rank()
        x = np.arange(2048, dtype=np.float64) + r
        if device:
            x = M.DeviceBuffer(x, device="cpu") if M is MPI \
                else M.DeviceBuffer(x)
        for _ in range(4):
            M.Allreduce(x, M.SUM, comm)
        h = M.Allreduce_init(np.ones(64) * r, np.zeros(64), M.SUM, comm)
        for _ in range(3):
            M.Start(h)
            M.Wait(h)
        M.Barrier(comm)
        M.Bcast(np.arange(16.0), 0, comm)
        perfvars.dump(str(tmp / f"pvars-rank{r}.json"), rank=r)
    perfvars.reset()            # the store is process-wide: this job alone
    M.testing.run_spmd(body, 4)
    return [json.load(open(tmp / f"pvars-rank{r}.json")) for r in range(4)]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    old = os.environ.get("TPU_MPI_PVARS")
    os.environ["TPU_MPI_PVARS"] = "1"
    JMPI.config.load(refresh=True)
    MPI.config.load(refresh=True)
    try:
        out = {}
        for name, M, pv in (("jax", JMPI, jperfvars), ("port", MPI, tperfvars)):
            for dev in (False, True):
                d = tmp_path_factory.mktemp(f"{name}{int(dev)}")
                out[(name, dev)] = _job(M, pv, d, device=dev)
        return out
    finally:
        if old is None:
            os.environ.pop("TPU_MPI_PVARS", None)
        else:
            os.environ["TPU_MPI_PVARS"] = old
        JMPI.config.load(refresh=True)
        MPI.config.load(refresh=True)


def _render(stats, records):
    out = io.StringIO()
    stats.render(stats.aggregate(records), out=out)
    return out.getvalue()


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_same_dumps_same_report_text(dumps, source, device):
    recs = dumps[(source, device)]
    text = _render(tstats, recs)
    assert text == _render(jstats, recs)
    assert "per-collective latency" in text and "allreduce" in text


@pytest.mark.parametrize("source", ["jax", "port"])
def test_same_dumps_same_aggregate(dumps, source):
    recs = dumps[(source, False)]
    a, b = tstats.aggregate(recs), jstats.aggregate(recs)
    assert repr(sorted(a.items(), key=str)) == repr(sorted(b.items(), key=str))


def test_both_packages_count_the_same_ops(dumps):
    """Each package's own job, aggregated: the same collectives counted."""
    def counts(recs):
        agg = tstats.aggregate(recs)
        return sorted((c, b, v[0]) for (c, _a, b), v in agg["colls"].items())
    assert counts(dumps[("port", False)]) == counts(dumps[("jax", False)])


def _snapshot(pkg, device_kw):
    import importlib
    serve = importlib.import_module(pkg + ".serve")
    from_broker = importlib.import_module(pkg + ".serve.broker")
    b = serve.Broker(nranks=2, token="tk", **device_kw)
    b.run_in_thread()
    try:
        with serve.attach(b.address, tenant="t0", token="tk") as s:
            for i in range(3):
                s.allreduce(np.arange(8, dtype=np.float32) + i)
            s.bcast(np.ones(4), root=1)
        rep = from_broker._stats_client(b.address, "tk")
        text = from_broker._metrics_client(b.address, "tk")
    finally:
        b.close()
    return rep, text


@pytest.fixture(scope="module")
def snapshots():
    return {"jax": _snapshot("tpu_mpi", {}),
            "port": _snapshot("tpu_mpi_torch", {"device": "cpu"})}


@pytest.mark.parametrize("source", ["jax", "port"])
def test_same_snapshot_same_exposition(snapshots, source):
    rep, _ = snapshots[source]
    text = tstats.to_prometheus(rep)
    assert text == jstats.to_prometheus(rep)
    assert tstats.parse_prometheus(text) == jstats.parse_prometheus(text)


@pytest.mark.parametrize("source", ["jax", "port"])
def test_metrics_frame_parses_the_same(snapshots, source):
    _, text = snapshots[source]
    assert tstats.parse_prometheus(text) == jstats.parse_prometheus(text)


def test_brokers_expose_the_same_metric_families(snapshots):
    """Same traffic, both brokers: the same metric names (values that time
    the run differ), and the same admitted-op counters. The port's pool
    hands the collective one staging tensor per (rank, dtype, shape), so
    its repeats arm the auto-arm lane, whose per-signature gauges the
    JAX broker (a fresh array per op) does not have."""
    def families(text):
        return {k.split("{")[0] for k in tstats.parse_prometheus(text)
                if "_auto_signatures_" not in k}
    jt, pt = snapshots["jax"][1], snapshots["port"][1]
    assert families(pt) == families(jt)
    jp, pp = tstats.parse_prometheus(jt), tstats.parse_prometheus(pt)
    for k in jp:
        if "admitted" in k or k.endswith("_nranks"):
            assert pp[k] == jp[k], k


def test_parse_rejects_what_the_reference_rejects():
    for bad in ("this is not exposition format\n",):
        with pytest.raises(ValueError):
            jstats.parse_prometheus(bad)
        with pytest.raises(ValueError):
            tstats.parse_prometheus(bad)


def _frames():
    healthy = {"address": "a:1",
               "queue": {"dispatched": 10, "rejected_busy": 0},
               "totals": {"bytes_sent": 100},
               "ledger": {"tenants": {"t0": {"slo": {
                   "burn": 1.5, "miss_frac": 0.015, "budget": 0.01,
                   "target_us": 2000, "ops": 40}}}}}
    later = json.loads(json.dumps(healthy))
    later["queue"]["dispatched"] = 25
    return [[healthy, {"address": "b:2", "error": "conn refused"}], [later]]


def test_watch_fleet_same_text():
    outs = []
    for stats in (jstats, tstats):
        frames = iter(_frames())
        out = io.StringIO()
        assert stats.watch_fleet(lambda: next(frames), interval=0.01,
                                 iterations=2, out=out,
                                 sleep=lambda s: None) == 0
        outs.append(out.getvalue())
    rate = re.compile(r"[0-9.]+/s")        # from the wall clock between frames
    assert rate.sub("R/s", outs[0]) == rate.sub("R/s", outs[1])
    assert "+15" in outs[1]


@pytest.mark.parametrize("records", [
    [], [{}, {"comms": None}, {"address": "x", "error": "dead"},
         {"comms": [], "plan_cache": None}],
    [{"comms": [{"size": 2, "bytes_sent": 10, "sends": 1}]},
     {"address": "gone", "error": "unreachable"}],
], ids=["empty", "partial", "dead-broker"])
def test_partial_records_same_report(records):
    assert _render(tstats, records) == _render(jstats, records)
    assert tstats.aggregate(records)["totals"] == \
        jstats.aggregate(records)["totals"]


def test_stats_cli_json_record(dumps, tmp_path):
    """``python -m tpu_mpi_torch.stats`` over the port's dumps: the JAX
    CLI's record, under the port's kind."""
    for r, rec in enumerate(dumps[("port", False)]):
        with open(tmp_path / f"pvars-rank{r}.json", "w") as f:
            json.dump(rec, f)
    out_json = tmp_path / "merged.json"
    assert tstats.main([str(tmp_path), "--json", str(out_json)]) == 0
    rec = json.load(open(out_json))
    assert rec["kind"] == "tpu_mpi_torch-stats"
    rows = {r["nbytes"]: r["count"] for r in rec["colls"]
            if r["coll"] == "allreduce"}
    assert rows == {2048 * 8: 16, 64 * 8: 12}   # 4 ranks x 4 ops, x 3 rounds
