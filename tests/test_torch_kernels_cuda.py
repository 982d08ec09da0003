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
