"""The port's fused fold (tpu_mpi_torch.kernels.fused_reduce) against the
Pallas kernel it replaces (tpu_mpi.xla.pallas_kernels.fused_multi_reduce),
which runs here in interpret mode as tests/test_pallas_kernels.py runs it.

The same numpy inputs, made from a seed, go through both. On CPU tensors
the wrapper runs its plain version (the chained PyTorch fold); the CUDA
kernel itself is held against that plain version on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py. Tolerance: none — every
case is bitwise (bfloat16 compared as raw bits, NaN positions as masks).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_mpi.xla import pallas_kernels as pk
from tpu_mpi_torch.buffers import from_numpy, to_numpy
from tpu_mpi_torch.kernels import _build, fused_reduce as fr

OPS = ["SUM", "PROD", "MAX", "MIN"]
DTYPES = ["float32", "float64", "bfloat16", "int32", "int64"]


def _inputs(dtype: str, n: int, size: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    if dtype.startswith("int"):
        return [rng.integers(-1000, 1000, size).astype(dtype) for _ in range(n)]
    # bfloat16 starts as float32 values, rounded to bfloat16 by each side
    return [rng.standard_normal(size).astype(
        "float32" if dtype == "bfloat16" else dtype) for _ in range(n)]


def _jax_fold(arrs, dtype, op, **kw):
    jd = jnp.bfloat16 if dtype == "bfloat16" else dtype
    out = pk.fused_multi_reduce([jnp.asarray(a, dtype=jd) for a in arrs],
                                op.lower(), interpret=True, **kw)
    out = np.asarray(out)
    return out.view(np.uint16) if dtype == "bfloat16" else out


def _torch_fold(arrs, dtype, op):
    td = torch.bfloat16 if dtype == "bfloat16" else None
    xs = [from_numpy(a, "cpu").to(td) if td else from_numpy(a, "cpu")
          for a in arrs]
    return to_numpy(fr.fused_multi_reduce(xs, op))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_fold_matches_pallas_kernel(op, dtype):
    arrs = _inputs(dtype, 5, 1000, seed=11)      # 1000: ragged vs 128 lanes
    want = _jax_fold(arrs, dtype, op)
    got = _torch_fold(arrs, dtype, op)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", OPS)
def test_fold_matches_pallas_multiblock_grid(op):
    # 40 rows at block 16 drives the Pallas grid over 3 padded blocks
    arrs = _inputs("float32", 4, 40 * 128 - 37, seed=12)
    np.testing.assert_array_equal(_torch_fold(arrs, "float32", op),
                                  _jax_fold(arrs, "float32", op, block_rows=16))


@pytest.mark.parametrize("op", ["MAX", "MIN"])
def test_nan_positions_match_pallas(op):
    arrs = _inputs("float32", 4, 515, seed=13)
    rng = np.random.default_rng(14)
    for a in arrs:
        a[rng.integers(0, a.size, 40)] = np.nan
    want = _jax_fold(arrs, "float32", op)
    got = _torch_fold(arrs, "float32", op)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep], want[keep])


def test_plain_fold_is_the_left_fold():
    xs = [torch.tensor([1e8, 1.0], dtype=torch.float32),
          torch.tensor([1.0, 1e8], dtype=torch.float32),
          torch.tensor([-1e8, -1e8], dtype=torch.float32)]
    # left fold: (1e8 + 1) rounds to 1e8, so both elements end at 0; a fold
    # from the right would keep element 1's 1.0
    assert fr.fused_multi_reduce(xs, "SUM").tolist() == [0.0, 0.0]


def test_cpu_wrapper_out_single_and_no_launch():
    xs = [torch.arange(6, dtype=torch.int64) + i for i in range(3)]
    before = fr.launches
    out = torch.empty(6, dtype=torch.int64)
    res = fr.fused_multi_reduce(xs, "SUM", out=out)
    assert res is out and out.tolist() == [3, 6, 9, 12, 15, 18]
    assert fr.fused_multi_reduce(xs[:1], "SUM") is xs[0]
    assert fr.launches == before        # the plain version is no launch


@pytest.mark.parametrize("bad", ["dtype", "shape", "empty", "op"])
def test_wrapper_rejects(bad):
    xs = [torch.zeros(4), torch.zeros(4)]
    with pytest.raises((ValueError, TypeError)):
        if bad == "dtype":
            fr.fused_multi_reduce([xs[0], xs[1].double()], "SUM")
        elif bad == "shape":
            fr.fused_multi_reduce([xs[0], torch.zeros(5)], "SUM")
        elif bad == "empty":
            fr.fused_multi_reduce([], "SUM")
        else:
            fr.fused_multi_reduce(xs, "LAND")


def test_kernel_table():
    assert fr.supports("SUM", torch.bfloat16)
    assert fr.supports("BXOR", torch.int8) and fr.supports("MIN", torch.bool)
    assert not fr.supports("BAND", torch.float32)
    assert not fr.supports("SUM", torch.complex64)
    assert fr.supports("SUM", torch.uint16) and fr.supports("BXOR", torch.uint64)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        fr.LIBRARY.build()


def test_library_path_keyed_by_source():
    p = fr.LIBRARY.path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("fused_reduce-")
    assert fr.LIBRARY.path() == p
