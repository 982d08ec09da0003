"""The DDP trainer's flat float64 state and its per-bucket pack and update
(tpu_mpi_torch.kernels.ddp_step) on the CPU, where the wrapper runs the
plain PyTorch sequences.

The trainer holds its masters and momentum as two flat tensors in arrival
order and folds a bucket's range at a time; the fold is elementwise, so it
must give, bit for bit, what the per-tensor sequence gives (reduced sum
times 1/world, momentum times mu plus that, masters minus momentum times
lr), whatever the bucket bound and the gradients' type.
"""

import functools

import numpy as np
import pytest
import torch

import tpu_mpi_torch as MPI
from tpu_mpi_torch import perfvars
from tpu_mpi_torch.kernels import ddp_step
from tpu_mpi_torch.train import DDPTrainer, GradBucketer
from tpu_mpi_torch.kernels._build import counts

TIMEOUT = 120
LR, MU = 1e-3, 0.9
STEPS = 3


def _spec():
    """Forward-order params of mixed sizes and shapes, enough of them that
    the smallest bucket bound lays out more buckets than one update launch
    takes on the card (ddp_step.SEG_MAX)."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (50,), (3, 4, 2), (1,), (129,), (16, 16)] * 7
    return {f"p{i}": rng.standard_normal(s) for i, s in enumerate(shapes)}


def _grads(step, rank, dtype):
    rng = np.random.default_rng(1000 * step + rank)
    return {n: torch.from_numpy(rng.standard_normal(a.shape)).to(dtype)
            for n, a in _spec().items()}


def _bits(t):
    return t.detach().to(torch.float64).contiguous().numpy().tobytes()


def _per_tensor_steps(world, dtype):
    """The trainer's fold a tensor at a time, as the trainer ran it before
    its state went flat: the rank-ordered float64 sum, then per tensor
    ``g = r * inv; m.mul_(mu).add_(g); p.sub_(m * lr)``."""
    params = {n: torch.from_numpy(a).reshape(-1).clone() for n, a in _spec().items()}
    mom = {n: torch.zeros_like(p) for n, p in params.items()}
    inv = 1.0 / world
    for s in range(STEPS):
        grads = [_grads(s, r, dtype) for r in range(world)]
        for n in params:
            r = functools.reduce(torch.add, [g[n].to(torch.float64).reshape(-1)
                                             for g in grads])
            g = r * inv
            mom[n].mul_(MU).add_(g)
            params[n].sub_(torch.mul(mom[n], LR, out=g))
    return params, mom


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("bucket_bytes", [64, 1024, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bucket_fold_gives_the_per_tensor_bits(world, bucket_bytes, dtype):
    """64 bytes: every tensor is larger than the bound and gets a bucket of
    its own (42 buckets); 1 MiB: one bucket holds them all."""
    def body():
        comm = MPI.COMM_WORLD
        tr = DDPTrainer(_spec(), comm, lr=LR, momentum=MU,
                        bucket_bytes=bucket_bytes, device="cpu")
        for s in range(STEPS):
            g = _grads(s, comm.rank(), dtype)
            tr.step((n, g[n]) for n in reversed(list(g)))
        return ({n: _bits(p) for n, p in tr.params.items()},
                {n: _bits(m) for n, m in tr._mom.items()}, len(tr.bucketer))

    outs = MPI.testing.run_spmd(body, world, timeout=TIMEOUT)
    params, mom = _per_tensor_steps(world, dtype)
    want = ({n: _bits(p) for n, p in params.items()},
            {n: _bits(m) for n, m in mom.items()})
    for got_params, got_mom, _ in outs:
        assert (got_params, got_mom) == want
    nbuckets = outs[0][2]
    if bucket_bytes == 64:
        assert nbuckets == len(params) > ddp_step.SEG_MAX
    elif bucket_bytes == 1 << 20:
        assert nbuckets == 1
    else:
        assert 1 < nbuckets < len(params)


def test_params_and_momentum_are_views_of_two_flats_in_arrival_order():
    def body():
        tr = DDPTrainer(_spec(), MPI.COMM_WORLD, bucket_bytes=1024, device="cpu")
        off = 0
        for name in tr.order:
            p, m = tr.params[name], tr._mom[name]
            assert p.untyped_storage().data_ptr() == tr._master.untyped_storage().data_ptr()
            assert p.data_ptr() == tr._master.data_ptr() + 8 * off
            assert tr._flat[name].data_ptr() == p.data_ptr()
            assert m.data_ptr() == tr._momentum.data_ptr() + 8 * off
            assert p.shape == _spec()[name].shape
            off += p.numel()
        assert off == tr._master.numel() == tr._momentum.numel()
        # the buckets tile the same arrival order
        assert [b.base for b in tr.bucketer.buckets] == \
            [sum(b.count for b in tr.bucketer.buckets[:i])
             for i in range(len(tr.bucketer))]
        assert tr.opt_state_bytes() == 8 * off
        return True

    assert MPI.testing.run_spmd(body, 2, timeout=TIMEOUT) == [True, True]


def test_bucket_add_copies_nothing_until_the_bucket_is_full():
    spec = [("a", 6), ("b", 6), ("c", 4)]
    bk = GradBucketer(spec, bucket_bytes=16 * 8, device="cpu")
    assert [b.names for b in bk.buckets] == [["a", "b", "c"]]
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7
    grads = {"a": torch.randn(2, 3, dtype=torch.float64).to(torch.bfloat16),
             "b": base[:, 1:3].T,                 # non-contiguous float32
             "c": np.array([1.5, -0.0, np.inf, np.nan])}
    copies = counts["ddp_pack_copies"]
    assert bk.add("a", grads["a"]) is None
    assert bk.add("b", grads["b"]) is None
    assert torch.equal(bk.buckets[0].send.value, torch.zeros(16, dtype=torch.float64))
    assert bk.add("c", grads["c"]) is bk.buckets[0]
    want = torch.zeros(16, dtype=torch.float64)
    off = 0
    for name, n in spec:
        g = grads[name]
        g = torch.from_numpy(g) if isinstance(g, np.ndarray) else g
        want.narrow(0, off, n).copy_(g.reshape(-1))
        off += n
    assert _bits(bk.buckets[0].send.value) == _bits(want)
    assert counts["ddp_pack_copies"] == copies     # the plain pack reads in place


def test_bucket_add_reads_a_gradient_when_its_bucket_packs():
    """The documented rule of DDPTrainer.step: a gradient is read when the
    last gradient of its bucket arrives, so a write to it before then is
    what is packed, and a write after it is not."""
    bk = GradBucketer([("a", 4), ("b", 4), ("c", 4)], bucket_bytes=8 * 8,
                      device="cpu")
    assert [b.names for b in bk.buckets] == [["a", "b"], ["c"]]
    a, b, c = torch.ones(4), torch.full((4,), 2.0), torch.full((4,), 3.0)
    assert bk.add("a", a) is None
    a.fill_(5.0)                              # before its bucket packs: read
    assert bk.add("b", b) is bk.buckets[0]
    a.fill_(7.0)                              # after: not read
    b.fill_(7.0)
    assert bk.buckets[0].send.value.tolist() == [5.0] * 4 + [2.0] * 4
    assert bk.add("c", c) is bk.buckets[1]
    assert bk.buckets[1].send.value.tolist() == [3.0] * 4


def test_cpu_steps_launch_no_kernel_and_the_counters_are_listed():
    names = ("ddp_pack_launches", "ddp_update_launches", "ddp_pack_copies")
    before = tuple(counts[name] for name in names)

    def body():
        tr = DDPTrainer(_spec(), MPI.COMM_WORLD, bucket_bytes=1024, device="cpu")
        g = _grads(0, MPI.COMM_WORLD.rank(), torch.float32)
        tr.step((n, g[n]) for n in reversed(list(g)))

    MPI.testing.run_spmd(body, 2, timeout=TIMEOUT)
    snap = perfvars.kernels_snapshot()
    assert tuple(snap[name] for name in names) == before


@pytest.mark.parametrize("bad", ["short gradient", "past the end", "float32 flat",
                                 "non-contiguous flat", "meta device"])
def test_pack_refuses_what_it_cannot_take(bad):
    dst = torch.zeros(8, dtype=torch.float64)
    parts = [(0, 4, torch.ones(4)), (4, 4, torch.ones(4))]
    if bad == "short gradient":
        parts[1] = (4, 4, torch.ones(3))
    elif bad == "past the end":
        parts[1] = (6, 4, torch.ones(4))
    elif bad == "float32 flat":
        dst = torch.zeros(8)
    elif bad == "non-contiguous flat":
        dst = torch.zeros(16, dtype=torch.float64)[::2]
    else:
        dst = torch.zeros(8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        ddp_step.pack(dst, parts)


@pytest.mark.parametrize("bad", ["short sum", "past the end", "float32 momentum",
                                 "sizes differ", "meta device"])
def test_update_refuses_what_it_cannot_take(bad):
    f64 = torch.float64
    master, mom = torch.zeros(8, dtype=f64), torch.zeros(8, dtype=f64)
    parts = [(0, 4, torch.ones(4, dtype=f64)), (4, 4, torch.ones(4, dtype=f64))]
    if bad == "short sum":
        parts[0] = (0, 4, torch.ones(5, dtype=f64))
    elif bad == "past the end":
        parts[1] = (5, 4, torch.ones(4, dtype=f64))
    elif bad == "float32 momentum":
        mom = torch.zeros(8)
    elif bad == "sizes differ":
        mom = torch.zeros(9, dtype=f64)
    else:
        master = torch.zeros(8, dtype=f64, device="meta")
        mom = torch.zeros(8, dtype=f64, device="meta")
    with pytest.raises(ValueError):
        ddp_step.update(master, mom, parts, 0.5, MU, LR)


def test_update_plain_is_the_per_tensor_sequence_with_specials():
    """NaN and signed zeros in the sums, inv 1, 1/2 and 1/4: each bucket's
    range takes the sequence a tensor at a time would."""
    rng = np.random.default_rng(11)
    counts = [5, 1, 300, 17]
    for inv in (1.0, 0.5, 0.25):
        sums = [torch.from_numpy(rng.standard_normal(c)) for c in counts]
        sums[0][:3] = torch.tensor([float("nan"), -0.0, 0.0], dtype=torch.float64)
        master = torch.from_numpy(rng.standard_normal(sum(counts)))
        mom = torch.from_numpy(rng.standard_normal(sum(counts)))
        want_p, want_m = master.clone(), mom.clone()
        parts, off = [], 0
        for c, r in zip(counts, sums):
            parts.append((off, c, r))
            g = r * inv
            m = want_m[off:off + c]
            m.mul_(MU).add_(g)
            want_p[off:off + c].sub_(torch.mul(m, LR, out=g))
            off += c
        ddp_step.update(master, mom, parts, inv, MU, LR)
        assert _bits(master) == _bits(want_p) and _bits(mom) == _bits(want_m)
