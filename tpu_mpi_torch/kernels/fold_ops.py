"""The Python side of ``csrc/fold_ops.cuh``: the dtype and op codes the
kernels' C interfaces take, which (dtype, op) pairs the kernels fold, and
the plain PyTorch step of each op — the fold step every kernel's plain
version applies, rounding as the kernel's Step<T, OP> does."""

from __future__ import annotations

import torch

from ..operators import (BAND, BOR, BXOR, MAX, MIN, NUMPY_RULES, PROD,
                         SUM)

# dtype -> kernel code (enum Dtype)
DTYPE_CODE = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3,
    torch.int8: 4, torch.int16: 5, torch.int32: 6, torch.int64: 7,
    torch.uint8: 8, torch.bool: 9, torch.uint16: 10, torch.uint32: 11,
    torch.uint64: 12,
}
_FLOAT_OPS = ("SUM", "PROD", "MAX", "MIN")
_INT_OPS = _FLOAT_OPS + ("BAND", "BOR", "BXOR")
# numpy's rules (operators.NUMPY_RULES): only the fused fold takes them,
# only on the dtypes numpy has
_NUMPY_OPS = ("NUMPY_SUM", "NUMPY_PROD", "NUMPY_MAX", "NUMPY_MIN")
_NUMPY_DTYPES = (torch.float16, torch.float32, torch.float64)
# op name -> kernel code (enum Op)
OP_CODE = {name: i for i, name in enumerate(_INT_OPS + _NUMPY_OPS)}

# The plain fold steps: the functions of the reduction operators of
# tpu_mpi_torch.operators themselves (which fold torch's unsigned 16, 32 and
# 64-bit types through their signed views).
PLAIN_STEP = {op.name: op.fn for op in (SUM, PROD, MAX, MIN, BAND, BOR, BXOR,
                                        *NUMPY_RULES.values())}


def supports(op: str, dtype: torch.dtype) -> bool:
    """Whether the kernels fold ``dtype`` under the op named ``op`` (a
    predefined op; numpy's rules on float16/32/64 in the fused fold)."""
    if dtype not in DTYPE_CODE:
        return False
    if op in _NUMPY_OPS:
        return dtype in _NUMPY_DTYPES
    ops = _FLOAT_OPS if dtype.is_floating_point else _INT_OPS
    return op in ops


def kernel_op(op: str, dtype: torch.dtype) -> str:
    """The op the kernel folds ``dtype`` with for the op named ``op``:
    numpy's rules differ from the shared steps only on numpy's float
    dtypes, so on every other dtype they are the predefined op itself."""
    if op in _NUMPY_OPS and dtype not in _NUMPY_DTYPES:
        return op[len("NUMPY_"):]
    return op
