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


@pytest.mark.parametrize("cls", [DDPTrainer, FSDPTrainer])
def test_checkpoints_wait_for_the_checkpoint_module(cls, tmp_path):
    def body():
        tr = cls(_spec(), MPI.COMM_WORLD, device="cpu")
        for call in (tr.save, tr.load):
            with pytest.raises(NotImplementedError, match="Queue A #8"):
                call(str(tmp_path / "ckpt"))

    _run(body)
