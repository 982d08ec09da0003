"""The port's fused fold (tpu_mpi_torch.kernels.fused_reduce) against the
Pallas kernel it replaces (tpu_mpi.xla.pallas_kernels.fused_multi_reduce),
which runs here in interpret mode as tests/test_pallas_kernels.py runs it.

The same numpy inputs, made from a seed, go through both. On CPU tensors
the wrapper runs its plain version (the chained PyTorch fold); the CUDA
kernel itself is held against that plain version on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py. Tolerance: none — every
case is bitwise (bfloat16 compared as raw bits, NaN positions as masks).
"""

import ctypes

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


# ---------------------------------------------------------------------------
# The kernel's route, chosen up front from pointers and sizes (plain Python,
# so it is checked here; the card tests force each route and hold both to
# the plain fold)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 16, 17])
def test_route_stages_aligned_tensors_at_any_n(n):
    xs = [torch.zeros(1024) for _ in range(n)]
    assert fr.route(xs, torch.empty(1024)) == "staged"
    # the in-graph path's operands: the rows of one stacked tensor
    rows = torch.zeros(n, 1024)
    assert fr.route(list(rows), torch.empty(1024)) == "staged"
    # out may be operand 0 itself (the RMA accumulate, a chained launch)
    assert fr.route(xs, xs[0]) == "staged"


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_route_views_at_an_offset_go_direct(offset):
    base = torch.zeros(4, 1024 + 4)
    xs = [base[k, offset:offset + 1024] for k in range(4)]
    assert all(x.is_contiguous() for x in xs)
    assert fr.route(xs, torch.empty(1024)) == "direct"
    # one misaligned operand among aligned ones, or a misaligned out
    aligned = [torch.zeros(1024) for _ in range(3)]
    assert fr.route(aligned + xs[:1], torch.empty(1024)) == "direct"
    assert fr.route(aligned, base[0, offset:offset + 1024]) == "direct"


@pytest.mark.parametrize("dtype,count,want", [
    (torch.float32, 8, "staged"),        # the serve tier's float32[8]
    (torch.float32, 4, "staged"),
    (torch.float32, 1027, "direct"),     # a ragged tail of 12 bytes
    (torch.float32, 1, "direct"),
    (torch.float64, 1, "direct"),        # RMA's 8-byte Fetch_and_op
    (torch.float64, 2, "staged"),
    (torch.int8, 16, "staged"),
    (torch.int8, 17, "direct"),
    (torch.bool, 4097, "direct"),
    (torch.float16, 4096, "staged"),
])
def test_route_whole_words_or_direct(dtype, count, want):
    xs = [torch.zeros(count, dtype=dtype) for _ in range(3)]
    assert fr.route(xs, torch.empty(count, dtype=dtype)) == want


def test_more_than_16_operands_fold_left_on_cpu():
    # 2^24 + 1 rounds back to 2^24 in float32, so only the left fold of
    # 2^24 and sixteen ones ends at 2^24 (any other order keeps some ones)
    xs = [torch.ones(5) for _ in range(17)]
    xs[0][0] = 2.0 ** 24
    got = fr.fused_multi_reduce(xs, "SUM")
    assert torch.equal(got, fr.fused_multi_reduce_plain(xs, "SUM"))
    assert got[0].item() == 2.0 ** 24 and got[1].item() == 17.0


def test_out_may_be_operand_0_on_cpu():
    xs = [torch.arange(6, dtype=torch.int32) + i for i in range(3)]
    want = fr.fused_multi_reduce_plain(xs, "SUM")
    assert fr.fused_multi_reduce(xs, "SUM", out=xs[0]) is xs[0]
    assert torch.equal(xs[0], want)


def _chained_launches(fn, device, what, ptrs, n, out, count, dtype, op, route,
                      stream=None):
    """The kernel's launch protocol (``FoldLaunch::run`` in
    csrc/fused_reduce.cu) on CPU memory, found by pointer: up to ``N_MAX``
    operands a launch, every launch after the first leading with the
    accumulator in ``out``; a launch reads its operands before it writes."""
    dt = {code: t for t, code in fr.DTYPE_CODE.items()}[dtype]
    step = fr.PLAIN_STEP[{code: o for o, code in fr.OP_CODE.items()}[op]]

    def at(ptr):
        raw = (ctypes.c_char * (count * dt.itemsize)).from_address(ptr)
        return torch.frombuffer(raw, dtype=dt)

    done = 0
    while done < n:
        srcs = [out] if done else []
        take = fr.N_MAX - len(srcs)
        srcs += [ptrs[k] for k in range(done, min(n, done + take))]
        done += take
        vals = [at(p).clone() for p in srcs]
        acc = vals[0]
        for v in vals[1:]:
            acc = step(acc, v)
        at(out).copy_(acc)


@pytest.mark.parametrize("k", range(17))
def test_chained_launch_into_every_operand(k, monkeypatch):
    """``out`` = operand k of 17 through the wrapper's launch path, the
    kernel played by its launch protocol on CPU memory: operand 16 is past
    the first launch, so the wrapper folds it fresh (else 136 + 136 = 272,
    not 153); one counted launch either way."""
    monkeypatch.setattr(fr.LIBRARY, "fn", lambda name: name)
    monkeypatch.setattr(fr._build, "call", _chained_launches)
    xs = [torch.full((8,), float(i + 1)) for i in range(17)]
    want = fr.fused_multi_reduce_plain(xs, "SUM")
    before = fr.launches
    assert fr._launch(xs, "SUM", xs[k], None) is xs[k]
    assert torch.equal(xs[k], want) and want[0].item() == 153.0
    assert fr.launches == before + 1


@pytest.mark.parametrize("window", ["shifted out", "shifted operand"])
def test_partially_overlapping_out_is_refused(window):
    base = torch.zeros(10)
    if window == "shifted out":
        xs, out = [base[:8], torch.zeros(8)], base[1:9]
    else:
        xs, out = [torch.zeros(8), base[2:10]], base[:8]
    with pytest.raises(ValueError, match="partially overlaps"):
        fr.fused_multi_reduce(xs, "SUM", out=out)


def test_unknown_route_is_refused_and_counts_reset():
    with pytest.raises(ValueError, match="no route"):
        fr.fused_multi_reduce([torch.zeros(4), torch.zeros(4)], "SUM", via="fast")
    before = dict(fr.route_launches)
    fr.fused_multi_reduce([torch.zeros(4), torch.zeros(4)], "SUM", via="direct")
    assert fr.route_launches == before          # the plain fold is no launch
    fr.reset_launches()
    assert fr.launches == 0 and set(fr.route_launches.values()) == {0}
    assert tuple(fr.route_launches) == fr.ROUTES == ("staged", "direct")
