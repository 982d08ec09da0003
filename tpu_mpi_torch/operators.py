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
        if _PREDEFINED.get(self.name) is self:
            return (_predefined_op, (self.name,))
        return (Op, (self.fn, self.commutative, self.name, self.ufunc))


def _sum(a, b):
    return a + b


def _prod(a, b):
    return a * b


def _min(a, b):
    return _xp(a).minimum(a, b)


def _max(a, b):
    return _xp(a).maximum(a, b)


def _like(a, out):
    """A logical result in ``a``'s dtype (``.to`` for tensors, ``.astype``
    for numpy), or in ``a``'s Python type for scalars."""
    if _is_torch(a):
        return out.to(a.dtype)
    return out.astype(a.dtype) if hasattr(a, "dtype") else type(a)(out)


def _land(a, b):
    xp = _xp(a)
    return _like(a, xp.logical_and(a != 0, b != 0))


def _lor(a, b):
    xp = _xp(a)
    return _like(a, xp.logical_or(a != 0, b != 0))


def _lxor(a, b):
    xp = _xp(a)
    return _like(a, xp.logical_xor(a != 0, b != 0))


def _band(a, b):
    return a & b


def _bor(a, b):
    return a | b


def _bxor(a, b):
    return a ^ b


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


def _predefined_op(name: str) -> Op:
    return _PREDEFINED[name]


def is_elementwise(op: Op) -> bool:
    """True when ``op`` is KNOWN to act independently per element — every
    predefined op, plus anything carrying a numpy ufunc. Chunk-separable
    transforms (the overlap engine's pipelined folds) require this: an
    arbitrary user callable might couple elements across the array, so it
    stays on the monolithic fold."""
    return op.ufunc is not None or _PREDEFINED.get(op.name) is op


def acc_combine(old: Any, incoming: Any, op: Op):
    """MPI accumulate semantics for a target range: the new target values,
    or None to leave the target unchanged (NO_OP). The single owner of the
    REPLACE/NO_OP dispatch used by both the in-process path
    (onesided._apply_op) and the cross-process wire engine
    (_rma_wire.ProcWinState.apply_acc)."""
    if op is REPLACE:
        return np.asarray(incoming, dtype=old.dtype)
    if op is NO_OP:
        return None
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
