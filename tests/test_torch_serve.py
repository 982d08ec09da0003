"""The port's serve tier against the JAX package's.

``tests/test_serve.py`` rebuilt against the port
(``test_torch_refport.port_module``; every broker on ``device="cpu"``),
each test under its reference name, and one seeded program driven
through a JAX broker and a port broker on the same numpy payloads: every
reply bitwise equal (all four reductions over float32/float64/int32/
int64/uint8/bool, replicated and per-rank parts, NaN and signed zeros
through all four, Bcast from every root; the pool folds with numpy's
rules, ``operators.NUMPY_RULES``, held on the card by
``tests/test_torch_kernels_cuda.py``), every error frame of the same
type and code, and
the ledger's admitted counters equal. Also: the port broker's device rule
(no card and no ``device="cpu"`` raises; an engine on an odd pool and an
elastic pool asked for a missing card raise typed), torch tensors from a client crossing as their numpy bits, and the
staging the pool does kept off the shared parts.
"""

import importlib
import threading

import numpy as np
import pytest
import torch

from tpu_mpi_torch.error import MPIError

from test_torch_refport import adopt, port_module

adopt(globals(), port_module("test_serve"))

TOKEN = "tk"
NRANKS = 4
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_]
REDUCES = ["sum", "prod", "min", "max"]


def _payload(rng, dtype, n=37, specials=True):
    if dtype == np.bool_:
        return rng.integers(0, 2, n).astype(bool)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        lo, hi = max(info.min, -50), min(info.max, 50)
        return rng.integers(lo, hi, n).astype(dtype)
    a = (rng.standard_normal(n) * 3).astype(dtype)
    if specials:
        a[:4] = [np.nan, 0.0, -0.0, np.inf]
        # across the ranks: zeros of both signs against each other, NaNs
        # of both signs, and NaN against a number
        a[4:8] = rng.permutation([0.0, -0.0, -np.nan, 1.0])
    return a


def program(serve, b, nranks=NRANKS):
    """The observations of one seeded session program: replies as
    (dtype, shape, bytes), errors as (type, code)."""
    rng = np.random.default_rng(20261017)
    obs = []

    def call(fn, *a, **kw):
        try:
            out = fn(*a, **kw)
        except MPIError as e:
            obs.append(("error", type(e).__name__, e.code))
            return
        except Exception as e:                 # noqa: BLE001 - typed frames
            obs.append(("error", type(e).__name__, getattr(e, "code", None)))
            return
        out = np.asarray(out)
        obs.append(("reply", out.dtype.str, out.shape, out.tobytes()))

    with serve.attach(b.address, tenant="alice", token=TOKEN) as s, \
            serve.attach(b.address, tenant="bob", token=TOKEN) as t:
        for dtype in DTYPES:
            for red in REDUCES:
                parts = [_payload(rng, dtype) for _ in range(nranks)]
                call(s.allreduce, parts, op=red)
                call(t.allreduce, parts[0], op=red)
        for root in range(nranks):
            call(s.bcast, _payload(rng, np.float64), root=root)
        call(s.allreduce, np.ones((3, 5), np.float32))       # 2-d part
        call(s.barrier)
        # typed errors: unknown op, parts that disagree, wrong part count,
        # a cid of another tenant, a root outside the comm
        call(s.allreduce, np.ones(4), op="xor")
        call(s.allreduce, [np.ones(4)] * (nranks - 1) + [np.ones(5)])
        call(s.allreduce, [np.ones(4)] * 2)
        from_t = type(s.comm)(s, t.comm.cid, nranks)
        call(s.allreduce, np.ones(4), comm=from_t)
        call(s.bcast, np.ones(4), root=nranks)
        call(s.allreduce, np.arange(6, dtype=np.int64))      # still usable
        led = b.ledger.report()["tenants"]
        obs.append(("ledger", sorted(
            (k, led[k]["admitted_ops"], led[k]["admitted_bytes"],
             led[k]["rejected_quota"], led[k]["rejected_busy"])
            for k in ("alice", "bob"))))
    return obs


def _drive(pkg, prog, **kw):
    serve = importlib.import_module(pkg + ".serve")
    if pkg == "tpu_mpi_torch":
        kw["device"] = "cpu"
    b = serve.Broker(nranks=kw.pop("nranks", NRANKS), token=TOKEN, **kw)
    b.run_in_thread()
    try:
        return prog(serve, b)
    finally:
        b.close()


def bounded(fn, seconds):
    """``fn()`` on a thread of its own, failing the test if it takes
    longer than ``seconds`` (a process test's own time limit)."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:          # noqa: BLE001 - re-raised below
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"took longer than its {seconds} s limit")
    if "err" in box:
        raise box["err"]
    return box["out"]


def assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g[:3], w[:3])


@pytest.mark.parametrize("transport", ["events", "threads"])
def test_replies_errors_and_ledger_bitwise_against_jax_broker(transport):
    want = _drive("tpu_mpi", program, transport=transport)
    got = _drive("tpu_mpi_torch", program, transport=transport)
    assert_same(got, want)
    assert sum(o[0] == "error" for o in got) == 5


def test_broker_without_a_card_raises_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default broker is valid")
    from tpu_mpi_torch import serve
    with pytest.raises(MPIError, match="device=\"cpu\""):
        serve.Broker(nranks=2, token=TOKEN)
    with pytest.raises(MPIError, match="device=\"cpu\""):
        serve.Broker(nranks=2, token=TOKEN, backend="procs")


@pytest.mark.parametrize("kw,item", [
    ({"infer": True, "nranks": 3, "device": "cpu"}, "even warm pool"),
    ({"elastic": True, "nranks": 2}, 'device="cpu"')])
def test_infer_and_elastic_raise_typed(kw, item):
    """``Broker(infer=...)`` and ``Broker(elastic=...)`` are served (the
    engine and the controller are ported); what they cannot serve raises a
    typed error before a tenant can attach: an engine on an odd pool (it
    needs two pipeline stages), an elastic pool asked for the card on a
    host without one."""
    from tpu_mpi_torch import serve
    with pytest.raises(MPIError, match=item):
        b = serve.Broker(token=TOKEN, **kw)
        try:
            b.start()
        finally:
            b.close()


def test_client_tensors_cross_as_their_numpy_bits():
    """A torch tensor handed to a session crosses as its numpy bits: the
    reply equals the one for the same numpy parts."""
    def prog(serve, b):
        rng = np.random.default_rng(3)
        parts = [rng.standard_normal(64).astype(np.float32)
                 for _ in range(NRANKS)]
        with serve.attach(b.address, tenant="tt", token=TOKEN) as s:
            a = s.allreduce(parts)
            t = s.allreduce([torch.from_numpy(p) for p in parts])
            c = s.bcast(torch.arange(5, dtype=torch.int64), root=2)
        return a, t, c
    a, t, c = _drive("tpu_mpi_torch", prog)
    assert a.tobytes() == t.tobytes() and t.dtype == np.float32
    assert c.tolist() == [0, 1, 2, 3, 4] and c.dtype == np.int64


def test_shared_part_is_staged_per_rank_and_left_alone():
    """A replicated part (one array for every rank): each rank stages its
    own tensor, so the fold never reads a tensor another rank writes, and
    a PROD of a shared part is the rank-ordered fold of one array."""
    def prog(serve, b):
        x = np.linspace(0.5, 1.5, 33).astype(np.float64)
        st, staged = b.pool.stager, []
        stage = st.stage
        st.stage = lambda r, part: staged.append(stage(r, part)) or staged[-1]
        with serve.attach(b.address, tenant="sh", token=TOKEN) as s:
            outs = [s.allreduce(x, op="prod") for _ in range(5)]
        return x, outs, staged
    x, outs, staged = _drive("tpu_mpi_torch", prog)
    want = ((x * x) * x) * x
    for o in outs:
        assert o.tobytes() == want.tobytes()
    # each rank staged every op into the one buffer it keeps for the shape
    assert len(staged) == 5 * NRANKS
    assert len({t.data_ptr() for t in staged}) == NRANKS
    assert x.tobytes() == np.linspace(0.5, 1.5, 33).tobytes()


def test_kept_staging_buffers_stay_within_the_budget():
    """A rank keeps device buffers for its recent (dtype, shape)s up to
    ``KEEP_BYTES``, the least recently used dropped first; a repeated
    shape gets the same buffer, and a part over the budget a new one."""
    from tpu_mpi_torch.serve.broker import _Stager
    st = _Stager("cpu")
    st.KEEP_BYTES = 1024
    a = st.stage(0, np.ones(64, np.float32))             # 256 B
    assert st.stage(0, np.zeros(64, np.float32)) is a
    assert st.stage(1, np.ones(64, np.float32)) is not a  # another rank's
    for n in (65, 66, 67):                                # 780 B more
        st.stage(0, np.ones(n, np.float32))
    assert st._held[0] <= 1024
    assert st.stage(0, np.ones(64, np.float32)) is not a  # dropped first
    big = np.ones(512, np.float32)                        # 2 KiB
    assert st.stage(0, big) is not st.stage(0, big)
    assert st._held[0] == sum(t.numel() * 4 for t in st._kept[0].values())


@pytest.mark.parametrize("operator", ["", "bcast=binomial",
                                      "allreduce=ring,bcast=binomial"])
def test_card_pool_pins_the_kernel_star_over_the_operators_settings(
        operator, monkeypatch):
    """A procs pool on the card gives its workers the monolithic star for
    Allreduce and no chunked star, whatever algorithm pins and pipeline
    threshold the operator set: a 64 MiB part is then folded at the root
    by the fold kernel, never by a tier that folds host copies. The
    operator's pins for other collectives stay."""
    from tpu_mpi_torch import config, tune
    from tpu_mpi_torch.overlap import ChunkSchedule
    from tpu_mpi_torch.serve.broker import _card_pool_env
    monkeypatch.setenv("TPU_MPI_PIPELINE_MIN_BYTES", "4096")
    monkeypatch.setenv("TPU_MPI_TUNE_EXPLORE", "0.5")
    if operator:
        monkeypatch.setenv("TPU_MPI_COLL_ALGO", operator)
    else:
        monkeypatch.delenv("TPU_MPI_COLL_ALGO", raising=False)
    import os
    for k, v in _card_pool_env(os.environ).items():
        monkeypatch.setenv(k, v)
    config.load(refresh=True)
    try:
        pins = tune.parse_override(config.load().coll_algo)
        assert pins["allreduce"] == "star"
        if "bcast" in operator:
            assert pins["bcast"] == "binomial"
        for nbytes in (32, 1 << 26):
            assert tune.select("allreduce", 4, nbytes, commutative=True,
                               elementwise=True) == "star"
        assert ChunkSchedule.maybe(1 << 24, 4) is None
    finally:
        monkeypatch.undo()
        config.load(refresh=True)
