"""``tests/test_serve_scale.py`` rebuilt against the port's serve tier
(``test_torch_refport.port_module``; brokers on ``device="cpu"``), each
test under its reference name, plus the seeded session program of
``tests/test_torch_serve.py`` through a JAX and a port broker on the
procs backend (pool workers as OS processes) and through a two-broker
fleet behind each package's router: replies, error frames and ledgers
bitwise equal.

``test_procs_sigkill_is_typed_and_survivors_bitwise_stable`` needs
``Broker(elastic=True)``; until ``elastic/`` is ported (ROADMAP Queue A
#11.4) the port's case asserts that typed refusal.
``test_router_pins_sessions_to_home_shard`` attaches 24 tenants where the
reference attaches 5: its rendezvous hash keys on the brokers' ephemeral
ports, and with 5 tenants all land on one broker in about one run of 16
(ROADMAP Queue C), which fails its "both brokers took tenants" check.
"""

import numpy as np
import pytest

from test_torch_refport import adopt, port_module
from test_torch_serve import TOKEN, _drive, assert_same, bounded, program

adopt(globals(), port_module("test_serve_scale"),
      skip=("test_procs_sigkill_is_typed_and_survivors_bitwise_stable",
            "test_router_pins_sessions_to_home_shard"))


def test_router_pins_sessions_to_home_shard(fleet):
    from tpu_mpi_torch import serve
    from tpu_mpi_torch.serve.router import assign_broker
    router, b0, b1 = fleet
    seen = set()
    for i in range(24):
        t = f"tenant{i}"
        s = serve.attach(router.address, tenant=t, token=TOKEN)
        try:
            got = s.allreduce(np.ones(4, np.int64))
            assert np.array_equal(got, np.full(4, 2))
            home = b0 if assign_broker(t, [b0.address, b1.address]) \
                == b0.address else b1
            seen.add(home.pool.shard.index)
            # the leased cid range proves which broker owns the session
            assert home.pool.shard.owns(s.cid_base)
            assert home.pool.shard.owns(s.cid_limit - 1)
        finally:
            s.detach()
    assert seen == {0, 1}       # both brokers actually took tenants


def test_procs_sigkill_is_typed_and_survivors_bitwise_stable():
    from tpu_mpi_torch import serve
    with pytest.raises(NotImplementedError, match="#11.4"):
        serve.Broker(nranks=3, token=TOKEN, backend="procs", elastic=True,
                     device="cpu")


@pytest.fixture
def one_thread(monkeypatch):
    # pool workers are processes: one BLAS/OpenMP thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_procs_backend_replies_bitwise_against_jax_broker(one_thread):
    def run(pkg):
        return _drive(pkg, lambda s, b: program(s, b, nranks=2),
                      nranks=2, backend="procs")
    want = bounded(lambda: run("tpu_mpi"), 120)
    got = bounded(lambda: run("tpu_mpi_torch"), 120)
    assert_same(got, want)


def _fleet_program(pkg):
    import importlib
    serve = importlib.import_module(pkg + ".serve")
    router_mod = importlib.import_module(pkg + ".serve.router")
    kw = {"device": "cpu"} if pkg == "tpu_mpi_torch" else {}
    brokers = [serve.Broker(nranks=2, token=TOKEN, shard=f"{i}/2", **kw)
               for i in range(2)]
    for b in brokers:
        b.run_in_thread()
    router = router_mod.Router([b.address for b in brokers], token=TOKEN)
    router.run_in_thread()
    try:
        rng = np.random.default_rng(11)
        out = []
        for i in range(6):
            with serve.attach(router.address, tenant=f"t{i}",
                              token=TOKEN) as s:
                parts = [rng.standard_normal(16) for _ in range(2)]
                out.append(s.allreduce(parts).tobytes())
                out.append(s.allreduce(parts[0], op="max").tobytes())
        return out
    finally:
        router.close()
        for b in brokers:
            b.close()


def test_router_fleet_replies_bitwise_against_jax_fleet():
    assert bounded(lambda: _fleet_program("tpu_mpi_torch"), 60) == \
        bounded(lambda: _fleet_program("tpu_mpi"), 60)
