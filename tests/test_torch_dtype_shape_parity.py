"""The port's host API against the JAX package over every dtype and shape.

One parametrised test over kind × op family × dtype × shape. Each case is
one SPMD program on 3 rank threads, written once against a package ``M``
and an array factory ``AT`` and run through both packages on the same
seeded numpy inputs, as ``test_torch_p2p`` runs its cases; the ops a
family takes share one run, a bitwise op a run of its own (a refused fold
fails the whole run). Every rank's result is
held to the JAX package's bitwise, shape and dtype included (bool as
numpy's bool; the conftest turns on jax's x64, so the JAX cell holds the
64-bit dtypes and the dtypes are compared as they stand). Where the JAX
package refuses a case (a bitwise op on floats, for example), the port
must refuse it too: both runs raise.

- Kinds: ``numpy`` (host arrays on both sides), ``devicebuffer`` (the
  port's cell on the CPU against the JAX cell) and ``tensor`` (raw CPU
  tensors against numpy on the JAX side).
- Shapes: ``()``, ``(0,)``, ``(5,)``, ``(2, 3)``. A 0-d operand stays 0-d
  through every family, as the JAX package keeps it.
- Complex PROD on tensors and cells is held to a relative tolerance of
  8 ulps of the modulus, NaN positions equal, not bitwise: numpy's
  complex multiply takes a SIMD path whose rounding depends on the host
  (complex64 products differ from torch's in the last bits, and from a
  plain ``(ar*br - ai*bi, ar*bi + ai*br)`` too), and XLA's takes its
  own. Numpy operands fold with numpy on both sides and stay bitwise.

Complex MAX and MIN follow numpy's rule (``np.maximum``: lexicographic on
(real, imag), a NaN part wins, ties keep the first operand) on every
kind. The JAX cell folds with ``jnp.maximum``, whose complex lowering
drops NaNs and keeps the second operand on ties, so the devicebuffer
kind's complex data here has neither; :func:`test_complex_max_min_specials`
holds every kind to numpy's bits with NaN and signed-zero elements.
"""

import numpy as np
import pytest

import tpu_mpi as JMPI
import tpu_mpi.testing  # noqa: F401  (JMPI.testing.run_spmd)
import tpu_mpi_torch as MPI
from tpu_mpi_torch.kernels._build import counts

from test_torch_p2p import AT, KINDS, TIMEOUT, host, same

NPROCS = 3
ROOT = 1

DTYPES = (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
          np.int64, np.uint64, np.float16, np.float32, np.float64, np.bool_,
          np.complex64, np.complex128)
SHAPES = ((), (0,), (5,), (2, 3))
REDUCE_OPS = ("SUM", "PROD", "MAX", "MIN", "BXOR")
FAMILIES = {
    "Allreduce": REDUCE_OPS, "Allreduce!": REDUCE_OPS, "Reduce": REDUCE_OPS,
    "Scan": REDUCE_OPS, "Exscan": REDUCE_OPS,
    "bcast": (None,), "Bcast!": (None,), "Sendrecv": (None,),
    "Recv": (None,), "Accumulate": ("MAX", "SUM"),
}


def data(rank: int, dtype, shape, specials: bool) -> np.ndarray:
    """Rank ``rank``'s seeded operand. Integers are small (PROD wraps
    alike on both sides); floats are normal draws (no zeros, no NaNs:
    ``torch.maximum`` on CPU tensors picks signed zeros by position, a
    known gap held on the card); complex values take NaN and signed-zero
    elements when ``specials``."""
    dt = np.dtype(dtype)
    rng = np.random.default_rng(1000 * rank + 17 * dt.num + len(shape))
    # np.array throughout: arithmetic on 0-d arrays gives a numpy scalar,
    # and a scalar operand takes the scalar lane, not the 0-d array's
    if dt.kind == "b":
        return np.array(rng.integers(0, 2, size=shape), dtype=dt)
    if dt.kind in "iu":
        lo = 0 if dt.kind == "u" else -3
        return np.array(rng.integers(lo, 7, size=shape), dtype=dt)
    if dt.kind == "f":
        return np.array(rng.standard_normal(size=shape), dtype=dt)
    a = np.array(rng.standard_normal(size=shape)
                 + 1j * rng.standard_normal(size=shape), dtype=dt)
    if specials and a.size:
        flat = a.reshape(-1)
        picks = [complex(np.nan, 1.0), complex(0.0, 0.0), complex(-0.0, 0.0),
                 complex(1.0, np.nan), complex(0.0, -0.0)]
        flat[rank % flat.size] = picks[rank % len(picks)]
    return a


def _host(v):
    return None if v is None else host(v)


def _family(M, AT, family, x, op, comm, rank, size, dtype, shape):
    """One call of ``family`` on operand ``x``; the rank's result."""
    count = int(np.prod(shape, dtype=np.int64))
    if family == "Allreduce":
        return M.Allreduce(x, op, comm)
    if family == "Allreduce!":
        y = AT.zeros(shape, dtype)
        M.Allreduce(x, y, op, comm)
        return y
    if family == "Reduce":
        return M.Reduce(x, op, ROOT, comm)
    if family == "Scan":
        return M.Scan(x, op, comm)
    if family == "Exscan":
        return M.Exscan(x, op, comm)
    if family == "bcast":
        return M.bcast(x if rank == ROOT else None, ROOT, comm)
    if family == "Bcast!":
        y = x if rank == ROOT else AT.zeros(shape, dtype)
        M.Bcast(y, ROOT, comm)
        return y
    if family == "Sendrecv":
        y = AT.zeros(shape, dtype)
        M.Sendrecv(x, (rank + 1) % size, 3, y, (rank - 1) % size, 3, comm)
        return y
    if family == "Recv":
        if rank == 0:
            M.Send(x, 1, 5, comm)
        elif rank == 1:
            y = AT.zeros(shape, dtype)
            M.Recv(y, 0, 5, comm)
            return y
        return None
    if family == "Accumulate":
        w = AT.wrap(data(rank + size, dtype, shape, specials=False))
        win = M.Win_create(w, comm)
        M.Win_fence(0, win)
        M.Accumulate(x, count, (rank + 1) % size, 0, op, win)
        M.Win_fence(0, win)
        win.free()
        return w
    raise AssertionError(family)


def program(M, AT, family, dtype, shape, specials, ops):
    def body():
        comm = M.COMM_WORLD
        rank, size = M.Comm_rank(comm), M.Comm_size(comm)
        out = {}
        for opname in ops:
            op = getattr(M, opname) if opname else None
            x = AT.wrap(data(rank, dtype, shape, specials))
            out[opname] = _host(_family(M, AT, family, x, op, comm, rank,
                                        size, dtype, shape))
        return out
    return body


def _close(j, t):
    """Complex PROD: NaN where the JAX package has NaN, elsewhere within
    8 ulps of the modulus (so a zero's sign is not held)."""
    j, t = np.asarray(j), np.asarray(t)
    if j.shape != t.shape or j.dtype != t.dtype:
        return False
    nan = np.isnan(j)
    if not np.array_equal(nan, np.isnan(t)):
        return False
    eps = np.finfo(j.dtype).eps
    return bool(np.all(np.abs(t[~nan] - j[~nan]) <= 8 * eps * np.abs(j[~nan])))


def _agree(kind, opname, dtype, j, t):
    if j is None or t is None:
        return j is t
    if (opname == "PROD" and np.dtype(dtype).kind == "c"
            and kind != "numpy"):
        return _close(j, t)
    return same(j, t)


@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "x".join(map(str, s)) or "0d")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_parity(kind, family, dtype, shape):
    specials = kind != "devicebuffer"
    ops = FAMILIES[family]
    # BXOR runs alone: a refused fold fails the whole run
    groups = [[o for o in ops if o != "BXOR"]] + \
        ([["BXOR"]] if "BXOR" in ops else [])
    bad = []
    for group in groups:
        j, t = (_run(M, KINDS[kind][M is MPI], family, dtype, shape,
                     specials, group) for M in (JMPI, MPI))
        if isinstance(j, Exception) or isinstance(t, Exception):
            if not (isinstance(j, Exception) and isinstance(t, Exception)):
                bad.append((group, "refused by one package only", j, t))
            continue
        for rank, (jr, tr) in enumerate(zip(j, t)):
            for opname in group:
                if not _agree(kind, opname, dtype, jr[opname], tr[opname]):
                    bad.append((rank, opname, jr[opname], tr[opname]))
    assert not bad, bad


def _run(M, wrap, family, dtype, shape, specials, ops):
    """Every rank's results, or the exception that failed the run."""
    try:
        return M.testing.run_spmd(
            program(M, AT(wrap), family, dtype, shape, specials, ops),
            NPROCS, timeout=TIMEOUT)
    except Exception as e:      # noqa: BLE001  (a refusal: compared above)
        return e


# ---------------------------------------------------------------------------
# complex MAX / MIN: numpy's bits with NaN and signed-zero elements
# ---------------------------------------------------------------------------

_C = (complex(np.nan, 0.0), complex(0.0, np.nan), complex(0.0, 0.0),
      complex(-0.0, 0.0), complex(0.0, -0.0), complex(1.0, 2.0),
      complex(1.0, 3.0), complex(np.inf, 0.0), complex(-np.inf, np.nan),
      complex(2.0, -1.0))


def _specials(rank: int, dtype) -> np.ndarray:
    """Every pair of :data:`_C` over ranks 0 and 1, rank 2 a shifted
    copy, and NaNs with payloads of their own on rank 1."""
    n = len(_C)
    a = np.array([_C[(i // n + (rank * (i % n))) % n] for i in range(n * n)],
                 dtype=dtype)
    if rank == 1:
        bits = a.view(np.uint32 if a.dtype == np.complex64 else np.uint64)
        nan = np.isnan(a.view(a.real.dtype))
        bits[nan] |= 0x15
    return a


def p_specials(M, AT, dtype, opname):
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        op = getattr(M, opname)
        x = AT.wrap(_specials(rank, dtype))
        red = M.Allreduce(x, op, comm)
        scan = M.Scan(x, op, comm)
        w = AT.wrap(_specials(rank + 1, dtype))
        win = M.Win_create(w, comm)
        M.Win_fence(0, win)
        M.Accumulate(x, len(_C) ** 2, (rank + 1) % NPROCS, 0, op, win)
        M.Win_fence(0, win)
        win.free()
        return host(red), host(scan), host(w)
    return body


@pytest.mark.parametrize("opname", ["MAX", "MIN"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("kind", list(KINDS))
def test_complex_max_min_specials(kind, dtype, opname):
    """Allreduce, Scan and Accumulate of complex operands with NaN and
    signed-zero elements give numpy's ``np.maximum``/``np.minimum`` bits
    in rank order, on every kind, as a chained fold (complex stays off the
    fold kernel)."""
    ufunc = np.maximum if opname == "MAX" else np.minimum
    xs = [_specials(r, dtype) for r in range(NPROCS)]
    want_red = ufunc(ufunc(xs[0], xs[1]), xs[2])
    want_scan = [xs[0], ufunc(xs[0], xs[1]), want_red]
    want_win = [ufunc(_specials(r + 1, dtype), xs[(r - 1) % NPROCS])
                for r in range(NPROCS)]
    before = counts["chained_folds"]
    t = MPI.testing.run_spmd(p_specials(MPI, AT(KINDS[kind][1]), dtype,
                                        opname), NPROCS, timeout=TIMEOUT)
    for r, (red, scan, w) in enumerate(t):
        assert same(red, want_red), (r, red, want_red)
        assert same(scan, want_scan[r]), (r, scan)
        assert same(w, want_win[r]), (r, w)
    if kind != "numpy":
        assert counts["chained_folds"] > before
