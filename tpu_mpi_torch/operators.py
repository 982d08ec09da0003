"""Reduction operators.

Reference: MPI.jl src/operators.jl — Op handle (:20), predefined
BAND/BOR/BXOR/LAND/LOR/LXOR/MAX/MIN/PROD/SUM/REPLACE/NO_OP (:22-37), dispatch
mapping Julia functions to builtins (:39-45), custom OpWrapper via @cfunction +
MPI_Op_create (:56-88).

Port mapping: ops are elementwise binary functions applied
array-at-a-time, to numpy arrays and to torch tensors alike. The predefined
SUM/PROD/MAX/MIN (and BAND/BOR/BXOR on integers) are what the fused fold
kernel (:mod:`tpu_mpi_torch.kernels.fused_reduce`) runs on the card; any
other callable runs as the chained fold on whatever array type it is given.

torch has no add, compare or logical kernels for ``uint16``, ``uint32`` and
``uint64`` tensors, on the CPU as on the card. The predefined ops fold those
through the signed view of the same width, with the same bits as numpy and
the JAX package: two's complement sums and products wrap as unsigned
arithmetic does, the bit operations act on the bits, and flipping the sign
bit maps the unsigned order onto the signed one for MAX and MIN.
"""

from __future__ import annotations

import operator as _pyop
from typing import Any, Callable, Optional

import numpy as np
import torch


def _host(a: Any) -> np.ndarray:
    """A numpy copy of an operand for the element-by-element fallback."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _is_torch(a: Any) -> bool:
    return isinstance(a, torch.Tensor)


def _xp(a: Any):
    """numpy-or-torch for a value (host path works on both array types)."""
    return torch if _is_torch(a) else np


class Op:
    """A reduction operator: an elementwise binary function.

    ``commutative`` gates re-associating algorithms (the multi-process ring
    allreduce); the in-process host path always reduces in rank order
    (deterministic, and what Scan/Exscan require). ``ufunc``, when set, is a
    numpy ufunc equivalent used for in-place reduction on hot paths.
    """

    def __init__(self, fn: Callable[[Any, Any], Any], commutative: bool = False,
                 name: Optional[str] = None, ufunc: Any = None):
        self.fn = fn
        self.commutative = commutative
        self.name = name or getattr(fn, "__name__", "custom")
        self.ufunc = ufunc

    def __call__(self, a: Any, b: Any) -> Any:
        try:
            return self.fn(a, b)
        except (TypeError, ValueError):
            # Scalar-only user function: apply elementwise (the analog of
            # OpWrapper's element loop, src/operators.jl:56-69).
            if _is_torch(a) or _is_torch(b):
                t = a if _is_torch(a) else b
                a2, b2 = _host(a), _host(b)
                vals = np.frompyfunc(self.fn, 2, 1)(a2, b2).astype(a2.dtype)
                return torch.from_numpy(vals).to(device=t.device, dtype=t.dtype)
            a2, b2 = np.asarray(a), np.asarray(b)
            out = np.frompyfunc(self.fn, 2, 1)(a2, b2)
            return out.astype(a2.dtype) if a2.dtype.kind != "O" else out

    def __repr__(self) -> str:
        return f"<Op {self.name}>"

    def __reduce__(self):
        # Predefined ops unpickle to their canonical singletons, so identity
        # checks (``op is REPLACE``) hold across process boundaries (the RMA
        # wire engine and cross-process collectives ship ops by pickle).
        if (_PREDEFINED.get(self.name) is self
                or NUMPY_RULES.get(self.name) is self):
            return (_predefined_op, (self.name,))
        return (Op, (self.fn, self.commutative, self.name, self.ufunc))


# torch's unsigned types that its kernels do not fold -> the signed view
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _signed(a: Any) -> Any:
    """``a`` as the signed view of its width when it is a tensor of one of
    :data:`_SIGNED`'s unsigned types, else ``a`` itself."""
    if _is_torch(a) and a.dtype in _SIGNED:
        return a.view(_SIGNED[a.dtype])
    return a


def _on_signed(step: Callable[[Any, Any], Any], a: Any, b: Any,
               ordered: bool = False) -> Any:
    """``step(a, b)``; for two tensors of one unsigned type of
    :data:`_SIGNED`, applied to their signed views and viewed back. An
    ``ordered`` step (MAX, MIN) sees the views with the sign bit flipped,
    which orders them as the unsigned values."""
    if not (_is_torch(a) and _is_torch(b) and a.dtype == b.dtype
            and a.dtype in _SIGNED):
        return step(a, b)
    sa, sb = _signed(a), _signed(b)
    if not ordered:
        return step(sa, sb).view(a.dtype)
    k = torch.iinfo(sa.dtype).min
    return (step(sa ^ k, sb ^ k) ^ k).view(a.dtype)


def _sum(a, b):
    return _on_signed(_pyop.add, a, b)


def _prod(a, b):
    return _on_signed(_pyop.mul, a, b)


def _min(a, b):
    return _on_signed(_xp(a).minimum, a, b, ordered=True)


def _max(a, b):
    return _on_signed(_xp(a).maximum, a, b, ordered=True)


def _like(a, out):
    """A logical result in ``a``'s dtype (``.to`` for tensors, ``.astype``
    for numpy), or in ``a``'s Python type for scalars."""
    if _is_torch(a):
        return out.to(a.dtype)
    return out.astype(a.dtype) if hasattr(a, "dtype") else type(a)(out)


def nonzero(a):
    """``a != 0``, for torch's unsigned types through the signed view."""
    return _signed(a) != 0


def _land(a, b):
    xp = _xp(a)
    return _like(a, xp.logical_and(nonzero(a), nonzero(b)))


def _lor(a, b):
    xp = _xp(a)
    return _like(a, xp.logical_or(nonzero(a), nonzero(b)))


def _lxor(a, b):
    xp = _xp(a)
    return _like(a, xp.logical_xor(nonzero(a), nonzero(b)))


def _band(a, b):
    return _on_signed(_pyop.and_, a, b)


def _bor(a, b):
    return _on_signed(_pyop.or_, a, b)


def _bxor(a, b):
    return _on_signed(_pyop.xor, a, b)


def _replace(a, b):
    return b


def _no_op(a, b):
    return a


SUM = Op(_sum, commutative=True, name="SUM", ufunc=np.add)
PROD = Op(_prod, commutative=True, name="PROD", ufunc=np.multiply)
MIN = Op(_min, commutative=True, name="MIN", ufunc=np.minimum)
MAX = Op(_max, commutative=True, name="MAX", ufunc=np.maximum)
LAND = Op(_land, commutative=True, name="LAND")
LOR = Op(_lor, commutative=True, name="LOR")
LXOR = Op(_lxor, commutative=True, name="LXOR")
BAND = Op(_band, commutative=True, name="BAND", ufunc=np.bitwise_and)
BOR = Op(_bor, commutative=True, name="BOR", ufunc=np.bitwise_or)
BXOR = Op(_bxor, commutative=True, name="BXOR", ufunc=np.bitwise_xor)
REPLACE = Op(_replace, commutative=False, name="REPLACE")
NO_OP = Op(_no_op, commutative=False, name="NO_OP")

_PREDEFINED = {op.name: op for op in (SUM, PROD, MIN, MAX, LAND, LOR, LXOR,
                                      BAND, BOR, BXOR, REPLACE, NO_OP)}


# ---- numpy's rules for the float folds (the serve tier's replies) -----------
#
# The serve tier replies what the JAX broker replies: numpy's rank-ordered
# fold on the host. Finite operands round alike everywhere, but numpy
# (x86) and the card pick other bits where a fold meets a NaN or zeros of
# both signs. These four ops fold float16/32/64 tensors with numpy's bits,
# as measured against numpy 2 on x86 at lengths 1 to 4099, in the plain
# version below and in the fold kernel (csrc/fold_ops.cuh, the NUMPY_*
# steps); every other dtype, and numpy operands, fold as SUM/PROD/MAX/MIN.
#
# * SUM/PROD: a NaN operand wins, quieted with its payload kept — of two
#   NaNs the first operand's (the accumulator's) for float32/float64 and
#   the second's for float16, as numpy's scalar loops pick; an invalid
#   operation (inf - inf, 0 * inf) gives x86's default NaN (sign set).
#   numpy's vectorised float32/float64 loops pick either operand of two
#   NaNs depending on the host (the second on some x86 hosts, the first
#   on others), so only there numpy's bits vary from machine to machine;
#   one NaN operand gives the same bits everywhere.
# * MAX/MIN: a NaN operand wins, the first operand's first, its bits
#   unchanged (a signalling NaN stays signalling); of two equal values
#   (zeros of both signs) float32/float64 take the second operand and
#   float16 the first.

# dtype -> (integer view, quiet bit, x86's default NaN)
_NP_BITS = {torch.float16: (torch.int16, 0x0200, -0x0200),
            torch.float32: (torch.int32, 0x00400000, -0x00400000),
            torch.float64: (torch.int64, 1 << 51, -(1 << 51))}


def _np_arith(step: Callable[[Any, Any], Any], a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    view, quiet, dnan = _NP_BITS[a.dtype]
    r = step(a, b)
    ia, ib, ir = a.view(view), b.view(view), r.view(view)
    na, nb = torch.isnan(a), torch.isnan(b)
    ir = torch.where(torch.isnan(r), ir.new_tensor(dnan), ir)
    first, second = ((nb, ib), (na, ia)) if a.dtype == torch.float16 \
        else ((na, ia), (nb, ib))
    ir = torch.where(second[0], second[1] | quiet, ir)
    ir = torch.where(first[0], first[1] | quiet, ir)
    return ir.view(a.dtype)


def _np_pick(greater: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    view = _NP_BITS[a.dtype][0]
    if a.dtype == torch.float16:                 # ties: the first operand
        wins = a >= b if greater else a <= b
    else:                                        # ties: the second operand
        wins = a > b if greater else a < b
    take_a = torch.isnan(a) | wins               # a NaN b loses every compare
    return torch.where(take_a, a.view(view), b.view(view)).view(a.dtype)


def _numpy_rules(base: Callable[[Any, Any], Any],
                 rule: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    def fn(a, b):
        if (_is_torch(a) and _is_torch(b) and a.dtype == b.dtype
                and a.dtype in _NP_BITS):
            return rule(a, b)
        return base(a, b)
    fn.__name__ = f"numpy_rules_{base.__name__.lstrip('_')}"
    return fn


NUMPY_SUM = Op(_numpy_rules(_sum, lambda a, b: _np_arith(torch.add, a, b)),
               commutative=True, name="NUMPY_SUM", ufunc=np.add)
NUMPY_PROD = Op(_numpy_rules(_prod, lambda a, b: _np_arith(torch.mul, a, b)),
                commutative=True, name="NUMPY_PROD", ufunc=np.multiply)
NUMPY_MAX = Op(_numpy_rules(_max, lambda a, b: _np_pick(True, a, b)),
               commutative=True, name="NUMPY_MAX", ufunc=np.maximum)
NUMPY_MIN = Op(_numpy_rules(_min, lambda a, b: _np_pick(False, a, b)),
               commutative=True, name="NUMPY_MIN", ufunc=np.minimum)

# the fold kernel's ops that are not MPI's predefined ones
NUMPY_RULES = {op.name: op for op in (NUMPY_SUM, NUMPY_PROD, NUMPY_MAX,
                                      NUMPY_MIN)}


def _predefined_op(name: str) -> Op:
    return _PREDEFINED.get(name) or NUMPY_RULES[name]


def is_elementwise(op: Op) -> bool:
    """True when ``op`` is KNOWN to act independently per element — every
    predefined op, plus anything carrying a numpy ufunc. Chunk-separable
    transforms (the overlap engine's pipelined folds) require this: an
    arbitrary user callable might couple elements across the array, so it
    stays on the monolithic fold."""
    return op.ufunc is not None or _PREDEFINED.get(op.name) is op


def acc_combine(old: Any, incoming: Any, op: Op, out: Any = None):
    """MPI accumulate semantics for a target range: the new target values,
    or None to leave the target unchanged (NO_OP). The single owner of the
    REPLACE/NO_OP dispatch of ``onesided._apply_op``.

    A numpy ``old`` gives a fresh array. A tensor result is written IN
    PLACE into ``out``, the target range itself (a contiguous view; by
    default ``old``), and returned: REPLACE copies the origin in, and every
    other op is the two-operand rank-ordered fold ``op(old, incoming)``
    through the Allreduce fold's candidate check — one launch of the fused
    fold kernel on a CUDA tensor for a predefined op it takes, else the
    chained fold (counted in ``collective.chained_folds``). An origin that
    overlaps the target range in part is read in full first, as numpy's
    assignment reads it (``buffers.detach_overlap``)."""
    if op is NO_OP:
        return None
    if _is_torch(old):
        from .buffers import as_tensor, detach_overlap
        from .collective import _tensor_fold
        out = old if out is None else out
        inc = detach_overlap(
            as_tensor(incoming, old.dtype, old.device).reshape(-1), out)
        if op is REPLACE:
            return out.copy_(inc)
        return _tensor_fold([old, inc.contiguous()], op, out=out)
    if op is REPLACE:
        return np.asarray(incoming, dtype=old.dtype)
    return np.asarray(op(old, np.asarray(incoming, dtype=old.dtype)))

# Function → builtin Op dispatch (src/operators.jl:39-45 maps + * min max & | ⊻).
_BUILTIN_MAP: dict[Any, Op] = {
    _pyop.add: SUM,
    _pyop.mul: PROD,
    min: MIN,
    max: MAX,
    _pyop.and_: BAND,
    _pyop.or_: BOR,
    _pyop.xor: BXOR,
    sum: SUM,
}


def as_op(op: Any) -> Op:
    """Normalize a user-supplied operator: Op | known builtin fn | any callable."""
    if isinstance(op, Op):
        return op
    mapped = _BUILTIN_MAP.get(op)
    if mapped is not None:
        return mapped
    if callable(op):
        return Op(op)
    raise TypeError(f"not a reduction operator: {op!r}")
