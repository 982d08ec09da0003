"""The fused fold kernel against its plain version, on the card.

These tests need an NVIDIA card and nvcc: the CUDA kernel has no CPU
mode, so on a CPU-only host they skip. The file imports neither jax nor
tpu_mpi, so it runs on a machine without them, apart from the repo's
conftest (which sets up jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from tpu_mpi_torch.kernels import fused_reduce as fr


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16,
                                   torch.float64, torch.int8, torch.int64,
                                   torch.uint8, torch.bool])
@pytest.mark.parametrize("n", [2, 17])
def test_kernel_matches_plain_on_card(dtype, n):
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    if dtype.is_floating_point:
        xs = [torch.randn(4097, generator=g, device=dev).to(dtype)
              for _ in range(n)]
    else:
        xs = [torch.randint(0, 2 if dtype == torch.bool else 100, (4097,),
                            generator=g, device=dev).to(dtype)
              for _ in range(n)]
    for op in ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR"):
        if not fr.supports(op, dtype):
            continue
        before = fr.launches
        got = fr.fused_multi_reduce(xs, op)
        want = fr.fused_multi_reduce_plain(xs, op)
        torch.cuda.synchronize()
        assert fr.launches == before + 1
        assert torch.equal(got, want), (dtype, op, n)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_on_card():
    dev = _card()
    x = torch.zeros(64, device=dev)
    with pytest.raises(ValueError):
        fr.fused_multi_reduce([x[::2], x[1::2]], "SUM")


@pytest.mark.cuda
def test_allreduce_main_path_on_card():
    import numpy as np
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective
    _card()
    rng = np.random.default_rng(1)
    data = [rng.standard_normal(3001).astype(np.float32) for _ in range(4)]
    want = fr.fused_multi_reduce_plain(
        [torch.from_numpy(d).cuda() for d in data], "SUM")
    before, chained = fr.launches, collective.chained_folds

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(data[r])
        y = MPI.DeviceBuffer(np.zeros(3001, np.float32))
        for _ in range(6):
            MPI.Allreduce(x, y, MPI.SUM, comm)
            assert y.value.is_cuda and torch.equal(y.value, want)
        req = MPI.Allreduce_init(x, y, MPI.SUM, comm)
        for _ in range(3):
            MPI.Start(req)
            MPI.Wait(req)
            assert torch.equal(y.value, want)

    MPI.testing.run_spmd(body, 4, timeout=120)
    assert fr.launches >= before + 9
    assert collective.chained_folds == chained


# ---------------------------------------------------------------------------
# Ring kernels (tpu_mpi_torch.kernels.ring)
# ---------------------------------------------------------------------------

_RING_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
                torch.int8, torch.int32, torch.int64, torch.uint8, torch.bool]


def _stacked(dtype, n, count, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(n, count, generator=g, device=dev).to(dtype)
    hi = 2 if dtype == torch.bool else 100
    return torch.randint(0, hi, (n, count), generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _RING_DTYPES)
@pytest.mark.parametrize("n", [2, 5])
def test_ring_kernels_match_plain_on_card(dtype, n):
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch.kernels import ring
    dev = _card()
    xs = _stacked(dtype, n, 8229, dev, 7)
    blocks = _stacked(dtype, n, n * 1031, dev, 8)
    for name in ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR"):
        if not fr.supports(name, dtype):
            continue
        op = getattr(MPI, name)
        combine = ring._combine_fn(op)[1]
        before = dict(ring.launches)
        got = ring.ring_allreduce(xs, op)
        want = ring.ring_allreduce_plain(xs, combine)
        got_rs = ring.ring_reduce_scatter(blocks, op)
        want_rs = ring.ring_reduce_scatter_plain(blocks, combine)
        torch.cuda.synchronize()
        assert ring.launches["ring_allreduce"] == before["ring_allreduce"] + 1
        assert ring.launches["ring_reduce_scatter"] == \
            before["ring_reduce_scatter"] + 1
        assert torch.equal(got, want), (dtype, name, n)
        assert torch.equal(got_rs, want_rs), (dtype, name, n)
    for shard in (xs, xs[:, 1:].contiguous()):       # 16-byte and narrower words
        before = ring.launches["ring_allgather"]
        got = ring.ring_allgather(shard)
        torch.cuda.synchronize()
        assert ring.launches["ring_allgather"] == before + 1
        assert torch.equal(got, ring.ring_allgather_plain(shard))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non-contiguous", "no ranks", "indivisible",
                                 "dtype"])
def test_ring_kernels_refuse_on_card(bad):
    from tpu_mpi_torch.kernels import ring
    dev = _card()
    x = torch.zeros(4, 64, device=dev)
    before = dict(ring.launches)
    with pytest.raises(ValueError):
        if bad == "non-contiguous":
            ring.ring_allreduce(x[:, ::2], "sum")
        elif bad == "no ranks":
            ring.ring_allgather(torch.zeros(0, 64, device=dev))
        elif bad == "indivisible":
            ring.ring_reduce_scatter(torch.zeros(4, 10, device=dev), "sum")
        else:
            ring.ring_allreduce(x.to(torch.complex64), "sum")
    assert ring.launches == before


@pytest.mark.cuda
def test_ingraph_tier_on_card():
    import numpy as np
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective, xla
    from tpu_mpi_torch.kernels import ring
    _card()
    mesh = xla.make_mesh({"x": 4})
    assert mesh.device.type == "cuda"
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal((4, 4 * 3001)).astype(np.float32)
                          ).to(mesh.device)
    folds, chained = fr.launches, collective.chained_folds
    before = dict(ring.launches)
    total = xla.allreduce(xs, MPI.SUM)
    shards = xla.reduce_scatter(xs, MPI.SUM)
    back = xla.allgather(shards, tiled=True)
    torch.cuda.synchronize()
    want = fr.fused_multi_reduce_plain(list(xs), "SUM")
    assert total.is_cuda and torch.equal(total[3], want)
    assert torch.equal(back[1], want)
    assert fr.launches == folds + 2
    assert ring.launches["ring_allgather"] == before["ring_allgather"] + 1
    assert collective.chained_folds == chained
