"""The port's data-parallel training tier (tpu_mpi_torch.train) against
tpu_mpi.train, over 4 rank threads with float64 masters on the CPU.

The same numpy gradients, made from seeds, feed both packages' trainers:
the port's DDP must give the JAX package's bits (both fold the buckets in
rank order and take the same float64 SGD(momentum) steps), its overlap
lane the blocking control's bits, and FSDP DDP's bits with 1/n of the
optimizer state. Every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

import tpu_mpi as JMPI
import tpu_mpi.testing  # noqa: F401  (JMPI.testing.run_spmd)
from tpu_mpi import train as jtrain

import tpu_mpi_torch as MPI
from tpu_mpi_torch import config as tconfig
from tpu_mpi_torch.buffers import IN_PLACE
from tpu_mpi_torch.collective import Allgather
from tpu_mpi_torch.train import (DDPTrainer, FSDPTrainer, GradBucketer,
                                 make_trainer)

NRANKS = 4
TIMEOUT = 120
CPU = torch.device("cpu")


def _spec():
    """A small 'model': named params in forward order, mixed sizes."""
    rng = np.random.default_rng(7)
    return {f"p{i}": rng.standard_normal(n)
            for i, n in enumerate((300, 50, 400, 120, 10, 256))}


def _grads(step, rank):
    rng = np.random.default_rng(10_000 * step + rank)
    return {name: rng.standard_normal(arr.size) for name, arr in _spec().items()}


def _feed(trainer, step, as_tensor=True):
    g = _grads(step, trainer.comm.rank())
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    trainer.step((n, conv(g[n])) for n in reversed(list(g)))


def _run(body):
    return MPI.testing.run_spmd(body, NRANKS, timeout=TIMEOUT)


def _bits(params):
    return {n: np.asarray(p, dtype=np.float64).tobytes() for n, p in params.items()}


# -- bucketer ----------------------------------------------------------------

def test_bucketer_layout_and_views():
    spec = [("a", 100), ("b", 100), ("c", 300), ("d", 10)]
    bk = GradBucketer(spec, bucket_bytes=200 * 8, device="cpu")
    # a+b fill bucket 0; c overflows the bound alone; d trails
    assert [b.names for b in bk.buckets] == [["a", "b"], ["c"], ["d"]]
    assert len(bk) == 3
    assert bk.add("a", torch.ones(100)) is None
    done = bk.add("b", np.full(100, 2.0))
    assert done is bk.buckets[0]
    assert done.send.value.dtype == torch.float64
    assert done.send.value[:100].tolist() == [1.0] * 100
    # a round rebinds recv to the lane's result: out_view reads the new one
    done.recv.setflat(done.send.value.clone())
    assert bk.out_view("b").tolist() == [2.0] * 100
    bk.reset()
    assert bk.add("a", torch.ones(100)) is None   # arrival set cleared


def test_bucketer_oversized_param_gets_own_bucket():
    bk = GradBucketer([("big", 10_000)], bucket_bytes=64, device="cpu")
    assert len(bk) == 1
    assert bk.buckets[0].nbytes == 80_000


def test_bucketer_goes_to_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match='device="cpu"'):
        GradBucketer([("a", 4)])


# -- DDP ---------------------------------------------------------------------

def test_ddp_overlap_bitwise_equals_control():
    outs = {}

    def body():
        comm = MPI.COMM_WORLD
        tr = DDPTrainer(_spec(), comm, bucket_bytes=1024, device="cpu")
        tc = DDPTrainer(_spec(), comm, bucket_bytes=1024, overlap=False,
                        device="cpu")
        assert len(tr.bucketer) > 1
        for s in range(4):
            _feed(tr, s)
            _feed(tc, s)
        if comm.rank() == 0:
            outs["overlap"], outs["control"] = _bits(tr.params), _bits(tc.params)
            outs["ofrac"] = (tr.overlap_fraction(), tc.overlap_fraction())

    _run(body)
    assert outs["overlap"] == outs["control"]
    assert outs["ofrac"][1] == 0.0


def test_ddp_bitwise_equals_the_jax_trainer():
    def port_body():
        tr = DDPTrainer(_spec(), MPI.COMM_WORLD, bucket_bytes=1024, device="cpu")
        for s in range(4):
            _feed(tr, s)
        assert all(p.device == CPU for p in tr.params.values())
        return _bits(tr.params)

    def jax_body():
        tr = jtrain.DDPTrainer(_spec(), JMPI.COMM_WORLD, bucket_bytes=1024)
        for s in range(4):
            _feed(tr, s, as_tensor=False)
        return _bits(tr.params)

    got = _run(port_body)
    want = JMPI.testing.run_spmd(jax_body, NRANKS, timeout=TIMEOUT)
    for r in range(NRANKS):
        assert got[r] == want[r], r
        assert got[r] == got[0]


def test_ddp_updates_do_not_alias_caller_params():
    def body():
        params = {n: torch.from_numpy(p) for n, p in _spec().items()}
        before = {n: p.clone() for n, p in params.items()}
        tr = DDPTrainer(params, MPI.COMM_WORLD, bucket_bytes=1024, device="cpu")
        _feed(tr, 0)
        for n in params:
            assert torch.equal(params[n], before[n])
            assert not torch.equal(tr.params[n], before[n])

    _run(body)


# -- FSDP --------------------------------------------------------------------

def test_fsdp_bitwise_equals_ddp_and_shards_state():
    outs = {}

    def body():
        comm = MPI.COMM_WORLD
        ddp = DDPTrainer(_spec(), comm, bucket_bytes=1024, device="cpu")
        fsdp = FSDPTrainer(_spec(), comm, device="cpu")
        for s in range(4):
            _feed(ddp, s)
            _feed(fsdp, s)
        if comm.rank() == 0:
            outs["ddp"], outs["fsdp"] = _bits(ddp.params), _bits(fsdp.params)
            outs["bytes"] = (ddp.opt_state_bytes(), fsdp.opt_state_bytes())

    _run(body)
    assert outs["ddp"] == outs["fsdp"]
    full, shard = outs["bytes"]
    assert full == 1136 * 8 and shard * NRANKS == full     # 1136 = 4 x 284


def test_allgather_in_place_on_tensors():
    def body():
        r = MPI.COMM_WORLD.rank()
        flat = torch.full((NRANKS * 3,), -1.0, dtype=torch.float64)
        flat[3 * r:3 * r + 3] = torch.arange(3, dtype=torch.float64) + 10 * r
        Allgather(IN_PLACE, flat, 3, MPI.COMM_WORLD)
        return flat.tolist()

    want = [10.0 * r + i for r in range(NRANKS) for i in range(3)]
    assert _run(body) == [want] * NRANKS


def test_make_trainer_honours_shard_state_config(monkeypatch):
    kinds = []

    def body():
        kinds.append(type(make_trainer(_spec(), MPI.COMM_WORLD, device="cpu",
                                       bucket_bytes=1024)).__name__)

    for env, kind in (("1", "FSDPTrainer"), ("0", "DDPTrainer")):
        monkeypatch.setenv("TPU_MPI_TRAIN_SHARD_STATE", env)
        tconfig.load(refresh=True)
        kinds.clear()
        _run(body)
        assert set(kinds) == {kind}
    monkeypatch.delenv("TPU_MPI_TRAIN_SHARD_STATE")
    tconfig.load(refresh=True)


# -- checkpoint resume / reshard ---------------------------------------------

PAIRS = {"ddp": (DDPTrainer, jtrain.DDPTrainer),
         "fsdp": (FSDPTrainer, jtrain.FSDPTrainer)}


def _state_bits(tr):
    """Params, then the optimizer state, as bytes (momentum flats for DDP,
    the momentum shard for FSDP)."""
    mom = tr._mom.values() if hasattr(tr, "_mom") else [tr._mshard]
    return (_bits(tr.params),
            [np.asarray(m, dtype=np.float64).tobytes() for m in mom])


@pytest.mark.parametrize("kind", list(PAIRS))
def test_checkpoint_resume_bitwise(kind, tmp_path):
    """Save after 2 steps, load into a fresh trainer, take 3 more: the
    same bits as 5 uninterrupted steps (tests/test_train.py:158-182)."""
    cls = PAIRS[kind][0]
    path = str(tmp_path / "train.ckpt")

    def body():
        comm = MPI.COMM_WORLD
        ref = cls(_spec(), comm, device="cpu")
        for s in range(5):
            _feed(ref, s)
        two = cls(_spec(), comm, device="cpu")
        for s in range(2):
            _feed(two, s)
        two.save(path)
        resumed = cls(_spec(), comm, device="cpu")
        ptrs = [p.data_ptr() for p in resumed.params.values()]
        assert resumed.load(path) == 2
        assert [p.data_ptr() for p in resumed.params.values()] == ptrs
        for s in range(2, 5):
            _feed(resumed, s)
        return _state_bits(ref) == _state_bits(resumed)

    assert _run(body) == [True] * NRANKS


@pytest.mark.parametrize("kind", list(PAIRS))
def test_checkpoint_reshards_4_to_2(kind, tmp_path):
    """A 4-rank checkpoint loaded by a 2-rank trainer: the params equal the
    saved ones, the optimizer state is the saved global state re-cut, and
    the next step equals the JAX package's trainer doing the same."""
    cls, jcls = PAIRS[kind]
    path = str(tmp_path / "train.ckpt")

    def save_body():
        tr = cls(_spec(), MPI.COMM_WORLD, device="cpu")
        for s in range(3):
            _feed(tr, s)
        tr.save(path)
        return _state_bits(tr)

    saved = _run(save_body)

    def load_body(M, make, as_tensor):
        def body():
            tr = make(_spec(), M.COMM_WORLD)
            assert tr.load(path) == 3
            before = _state_bits(tr)
            _feed(tr, 3, as_tensor)
            return before, _state_bits(tr)
        return body

    got = MPI.testing.run_spmd(load_body(MPI, lambda p, c: cls(p, c, device="cpu"),
                                         True), 2, timeout=TIMEOUT)
    want = JMPI.testing.run_spmd(load_body(JMPI, jcls, False), 2, timeout=TIMEOUT)
    assert got == want
    for r in range(2):
        assert got[r][0][0] == saved[0][0]          # params as saved
    if kind == "ddp":
        assert got[0][0][1] == saved[0][1]          # replicated momentum
    else:                                           # momentum re-cut 4 -> 2
        full = b"".join(saved[r][1][0] for r in range(NRANKS))
        half = len(full) // 2
        assert [got[r][0][1][0] for r in range(2)] == [full[:half], full[half:]]


@pytest.mark.parametrize("kind", list(PAIRS))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_between_the_packages(kind, writer, tmp_path):
    """A checkpoint written by one package's trainer resumes in the other's
    with the bits of the writer's own uninterrupted run; for the same state
    the two packages write the same file."""
    cls, jcls = PAIRS[kind]
    paths = {"jax": str(tmp_path / "jax.ckpt"), "torch": str(tmp_path / "t.ckpt")}

    def body(M, make, as_tensor, save_to=None, load_from=None):
        def run():
            tr = make(_spec(), M.COMM_WORLD)
            if load_from is not None:
                assert tr.load(load_from) == 2
            start = 2 if load_from is not None else 0
            for s in range(start, 4):
                _feed(tr, s, as_tensor)
                if s == 1 and save_to is not None:
                    tr.save(save_to)
            return _state_bits(tr)
        return run

    port = lambda p, c: cls(p, c, device="cpu")   # noqa: E731
    jrun, trun = JMPI.testing.run_spmd, MPI.testing.run_spmd
    ref_j = jrun(body(JMPI, jcls, False, save_to=paths["jax"]), NRANKS, timeout=TIMEOUT)
    ref_t = trun(body(MPI, port, True, save_to=paths["torch"]), NRANKS, timeout=TIMEOUT)
    assert ref_j == ref_t
    with open(paths["jax"], "rb") as f, open(paths["torch"], "rb") as g:
        assert f.read() == g.read()
    if writer == "jax":
        got = trun(body(MPI, port, True, load_from=paths["jax"]), NRANKS,
                   timeout=TIMEOUT)
    else:
        got = jrun(body(JMPI, jcls, False, load_from=paths["torch"]), NRANKS,
                   timeout=TIMEOUT)
    assert got == ref_j


def test_ddp_save_stages_only_its_slice(monkeypatch, tmp_path):
    """Each DDP rank stages to host its own slice of the packed state,
    cut as np.array_split cuts it (the JAX package packs the whole state on
    every rank first)."""
    from tpu_mpi_torch.train import ddp as tddp
    staged = []
    real = tddp.stage_range

    def spy(segs, lo, hi):
        staged.append((lo, hi))
        return real(segs, lo, hi)

    monkeypatch.setattr(tddp, "stage_range", spy)

    def body():
        DDPTrainer(_spec(), MPI.COMM_WORLD, device="cpu").save(
            str(tmp_path / "d.ckpt"))

    _run(body)
    total = 2 * 1136
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.zeros(total), NRANKS)])
    assert sorted(staged) == [(int(bounds[r]), int(bounds[r + 1]))
                              for r in range(NRANKS)]
