"""The fold's numpy rules (``operators.NUMPY_RULES``): the plain version
of the fold kernel's ``NUMPY_*`` steps, which the serve pool folds with,
held bitwise to numpy's own fold on the host.

Each float dtype the serve tier accepts (float16/32/64) under SUM, PROD,
MAX and MIN, over every ordered pair of quiet and signalling NaNs of
both signs, infinities (``inf - inf``, ``0 * inf``), signed zeros, a
subnormal, the largest finite value and numbers, at lengths 1, 7, 8, 17
and 4099, so numpy's scalar loops and its vectorised body and tail are
all met. The one place numpy's bits depend on the host is a SUM or PROD
of two NaNs in float32/float64: its scalar loop takes the first
operand's, its vectorised loop either one, by host; the rules take
numpy's scalar loop's pick, the first operand's (the second's for
float16), and the tests hold those positions to numpy's scalar loop. The
card holds the kernel to the same bits (``tests/test_torch_kernels_cuda.py``).
"""

import pickle

import numpy as np
import pytest
import torch

from numpy_rules_cases import (NUMPY_OPS, numpy_fold_bits, pair_cases,
                               specials, uint_of)
from tpu_mpi_torch import collective, operators
from tpu_mpi_torch.kernels import fold_ops
from tpu_mpi_torch.kernels import fused_reduce as fr

DTYPES = ["float16", "float32", "float64"]


@pytest.mark.parametrize("length", [1, 7, 8, 17, 4099])
@pytest.mark.parametrize("op", sorted(NUMPY_OPS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_numpy_rules_match_numpy_bitwise(dtype, op, length):
    u = uint_of(dtype)
    for a, b in pair_cases(dtype, length):
        want = numpy_fold_bits(NUMPY_OPS[op], a, b)
        got = fr.fused_multi_reduce([torch.from_numpy(a), torch.from_numpy(b)],
                                    op)
        assert (got.numpy().view(u) == want).all(), (a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_of_two_nans_the_sum_keeps_numpy_scalar_loops_pick(dtype):
    """Of two NaNs a SUM or PROD keeps the accumulator's (float32,
    float64) or the incoming operand's (float16), quieted, as numpy's
    scalar loop does, at every length."""
    u = uint_of(dtype)
    first, second = specials(dtype)[:2]          # NaNs of both signs
    keep = second if dtype == "float16" else first
    for length in (1, 4096):
        a, b = np.full(length, first), np.full(length, second)
        assert (np.add(a[:1], b[:1]).view(u) == keep.view(u)).all()
        for op in (operators.NUMPY_SUM, operators.NUMPY_PROD):
            got = op(torch.from_numpy(a), torch.from_numpy(b))
            assert (got.numpy().view(u) == keep.view(u)).all()


@pytest.mark.parametrize("op", sorted(NUMPY_OPS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_four_rank_fold_matches_numpy_fold(dtype, op):
    """A rank-ordered fold of four parts seeded with specials, as the
    serve pool folds them, against numpy's fold of the same parts, step
    by step (two NaNs of a SUM or PROD at numpy's scalar loop's pick)."""
    rng = np.random.default_rng(12)
    s = np.concatenate([specials(dtype),
                        rng.standard_normal(4).astype(dtype)])
    parts = [rng.choice(s, 4099) for _ in range(4)]
    u = uint_of(dtype)
    want = parts[0]
    for p in parts[1:]:
        want = numpy_fold_bits(NUMPY_OPS[op], want, p).view(dtype)
    got = fr.fused_multi_reduce([torch.from_numpy(p) for p in parts], op)
    assert got.numpy().view(u).tobytes() == want.view(u).tobytes()


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.bool,
                                   torch.bfloat16, torch.float32])
def test_numpy_rules_enter_the_fold_kernel(dtype):
    """Every reduce the serve tier takes is one launch of the fold kernel:
    numpy's rules on numpy's float dtypes, the predefined op itself on
    every other (where the two agree, and numpy has no bfloat16)."""
    for name in ("SUM", "PROD", "MAX", "MIN"):
        op = operators.NUMPY_RULES["NUMPY_" + name]
        kop = collective._kernel_op(op, dtype)
        want = ("NUMPY_" + name if dtype in (torch.float16, torch.float32,
                                              torch.float64) else name)
        assert kop == want and fold_ops.supports(kop, dtype)
        assert pickle.loads(pickle.dumps(op)) is op


def test_serve_pool_folds_with_numpy_rules():
    from tpu_mpi_torch.serve import broker
    for name, op in (("sum", operators.NUMPY_SUM), ("prod", operators.NUMPY_PROD),
                     ("min", operators.NUMPY_MIN), ("max", operators.NUMPY_MAX)):
        assert broker._reduce_op(name) is op
