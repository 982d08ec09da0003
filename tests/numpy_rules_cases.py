"""Operand pairs for the fold's numpy rules (``operators.NUMPY_RULES``,
the ``NUMPY_*`` steps of ``csrc/fold_ops.cuh``): every pair of quiet and
signalling NaNs of both signs, infinities, signed zeros, a subnormal, the
largest finite value and plain numbers, laid out at a given length.
Imported by the host test and the card test; numpy only."""

import numpy as np

NUMPY_OPS = {"NUMPY_SUM": np.add, "NUMPY_PROD": np.multiply,
             "NUMPY_MAX": np.maximum, "NUMPY_MIN": np.minimum}

# dtype -> (quiet NaN, negative quiet NaN, signalling NaN, negative
#           signalling NaN, smallest subnormal), as bit patterns
_NAN_BITS = {
    "float16": (0x7E12, 0xFE34, 0x7C05, 0xFC21, 0x0001),
    "float32": (0x7FC01234, 0xFFC05678, 0x7F800005, 0xFF800021, 0x00000001),
    "float64": (0x7FF8000000001234, 0xFFF8000000005678, 0x7FF0000000000005,
                0xFFF0000000000021, 0x0000000000000001),
}


def uint_of(dtype) -> np.dtype:
    return np.dtype(np.dtype(dtype).str.replace("f", "u"))


def specials(dtype) -> np.ndarray:
    dt = np.dtype(dtype)
    nan_bits = np.array(_NAN_BITS[dt.name], uint_of(dt)).view(dt)
    plain = np.array([np.inf, -np.inf, 0.0, -0.0, 1.5, -2.25,
                      np.finfo(dt).max], dt)
    return np.concatenate([nan_bits, plain])


def pair_cases(dtype, length: int):
    """``[(a, b), ...]``: arrays of ``length`` elements that together hold
    every ordered pair of :func:`specials` (the last one cycled to fill)."""
    s = specials(dtype)
    xs = np.repeat(s, s.size)
    ys = np.tile(s, s.size)
    out = []
    for lo in range(0, xs.size, length):
        idx = (np.arange(length) + lo) % xs.size
        out.append((xs[idx].copy(), ys[idx].copy()))
    return out


def scalar_bits(ufunc, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``ufunc(a, b)`` element by element, as numpy's scalar loop (one
    element a call) computes it."""
    with np.errstate(all="ignore"):
        return np.concatenate([ufunc(a[i:i + 1], b[i:i + 1])
                               for i in range(a.size)])


def numpy_fold_bits(ufunc, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """numpy's ``ufunc(a, b)`` as the bits the fold's numpy rules give:
    numpy's own at every position but where both operands of a SUM or
    PROD are NaN, which takes numpy's scalar loop's bits (its vectorised
    float32/float64 loops pick either NaN of two, depending on the host)."""
    u = uint_of(a.dtype)
    with np.errstate(all="ignore"):
        want = ufunc(a, b).view(u)
    if ufunc in (np.add, np.multiply):
        both = np.isnan(a) & np.isnan(b)
        if both.any():
            want = want.copy()
            want[both] = scalar_bits(ufunc, a[both], b[both]).view(u)
    return want
