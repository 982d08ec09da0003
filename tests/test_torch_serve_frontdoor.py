"""``tests/test_serve_frontdoor.py`` rebuilt against the port's serve tier
(``test_torch_refport.port_module``; brokers on ``device="cpu"``), each
test under its reference name, plus front-door traffic driven through a
JAX and a port events broker: concurrent tenants whose frames land in
registered receive buffers (recycled recv leases), payloads wider than
the iovec limit and larger than a lease, and the python readiness
engine; every reply bitwise equal, and the recycled buffers never leak
into a later reply.
"""

import threading

import numpy as np

from test_torch_refport import adopt, port_module
from test_torch_serve import TOKEN, _drive, bounded

adopt(globals(), port_module("test_serve_frontdoor"))


def _concurrent(serve, b, tenants=6, ops=12):
    """Tenants on threads, each a seeded stream of allreduces of mixed
    sizes; replies by (tenant, op) so thread timing cannot reorder them."""
    out = {}
    errs = []

    def run(i):
        rng = np.random.default_rng(100 + i)
        try:
            with serve.attach(b.address, tenant=f"fd{i}", token=TOKEN) as s:
                for k in range(ops):
                    n = int(rng.choice([8, 700, 4096, 70000]))
                    parts = [rng.standard_normal(n).astype(np.float32)
                             for _ in range(4)]
                    out[(i, k)] = s.allreduce(parts).tobytes()
        except BaseException as e:          # noqa: BLE001
            errs.append(e)
    ts = [threading.Thread(target=run, args=(i,)) for i in range(tenants)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs
    return out


def test_concurrent_front_door_replies_bitwise_against_jax_broker():
    want = bounded(lambda: _drive("tpu_mpi", _concurrent,
                                  transport="events"), 90)
    got = bounded(lambda: _drive("tpu_mpi_torch", _concurrent,
                                 transport="events"), 90)
    assert got == want


def test_python_readiness_engine_replies_the_same_bits(monkeypatch):
    """The python readiness engine (the native one's fallback) through the
    same traffic: the JAX broker's bits."""
    from tpu_mpi_torch.serve import frontdoor as fdmod
    monkeypatch.setattr(fdmod, "_make_engine",
                        lambda: (fdmod._PyFdEngine(), "python"))
    prog = lambda s, b: _concurrent(s, b, 3, 6)     # noqa: E731
    got = bounded(lambda: _drive("tpu_mpi_torch", prog,
                                 transport="events"), 90)
    want = bounded(lambda: _drive("tpu_mpi", prog, transport="events"), 90)
    assert got == want
