"""Ring attention of n ranks on one card: the port of the Pallas kernel
``ring_attention`` of ``tpu_mpi/xla/pallas_kernels.py``.

``ring_attention(q, k, v, causal=...)`` takes the stacked per-rank blocks of
a sequence sharded over n ranks, rank axis first: ``(n, t, d)`` as the TPU
kernel sees one head, or ``(n, BH, t, d)`` with batch and heads written out
where the TPU wrapper is vmapped. Rank r's block holds global positions
``r*t .. r*t + t - 1``. It returns the attention output block of every rank,
``(n, [BH,] t, d)``, in the input dtype (float32 or bfloat16), with
``causal=True`` masking by global position.

On a CUDA tensor the wrapper launches one of three hand-written kernels,
chosen by :func:`route` from the dtype, the head dim and the alignment, or
raises:

- ``"sm90"``: bfloat16 with ``d % 8 == 0`` and 16-byte-aligned bases (every
  model-path call), ``tpu_mpi_torch/csrc/ring_attention_sm90.cu``: TMA-fed
  K/V tiles, wgmma, a producer warp and two consumer warpgroups;
- ``"mma_sync"``: the other bfloat16 head dims,
  ``tpu_mpi_torch/csrc/ring_attention.cu`` on mma.sync;
- ``"fma"``: float32, the same file, FMA at the TPU kernel's HIGHEST
  precision (TF32 wgmma would miss the float32 tolerance).

On a CPU tensor it runs :func:`ring_attention_plain`, which replays the TPU
kernel's schedule on the stacked tensors: n ring steps with the K/V rotation
as a ``roll`` of the stacked blocks (step s holds block ``(r - s) % n``), the
same Q panels (``bq = t`` up to 1024 rows, else 512), float32 state with m
starting at -1e30, scores scaled in float32, masked keys -inf, P rounded to
the input dtype before P.V, ``acc / l`` cast back. It is also the kernels'
oracle on the card. The kernels fold key tiles where the TPU kernel folds
whole panels (and the sm90 kernel takes exp as exp2 with the scale folded
in), so they agree with it to a tolerance, not to bits; see the sources.

Bound on the card: Q, K, V read and O written once against ``4 d`` flops
per unmasked (query, key) pair, whichever takes longer.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from . import _build
from .fold_ops import DTYPE_CODE

SOURCE = _build.CSRC / "ring_attention.cu"
SOURCE_SM90 = _build.CSRC / "ring_attention_sm90.cu"
REPLACES = "tpu_mpi/xla/pallas_kernels.py:574"      # ring_attention
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
ROUTES = ("sm90", "mma_sync", "fma")
SUBLANE = 8         # the TPU wrapper's multiple for the local sequence length
M_INIT = -1e30      # the running max's start
# The kernel against the plain version on the card, elementwise (see
# ``allowed_error``). float32: |got - want| <= atol + rtol |want|, both sum in
# float32 in other orders (key tiles against whole panels). bfloat16:
# |got - want| <= 2^-7 (A + |want|), A the attention of |v| in float32. Each
# side rounds every p to bfloat16 (relative error <= 2^-8) against its own
# running max, so the two float32 outputs differ by at most
# 2 * 2^-8 * sum_j p_j |v_j| / l = 2^-7 A, and their bfloat16 roundings
# (half an ulp, <= 2^-8 of the value, each) by at most 2^-7 |want| more;
# the bound carries 2^-6 of itself for float32 sums and exp.
F32_TOLERANCE = (1e-4, 1e-4)
BF16_REL = 2.0 ** -7 * (1 + 2.0 ** -6)
TOLERANCE_NOTE = ("float32 |got-want| <= 1e-4 + 1e-4|want|; bfloat16 |got-want| "
                  "<= 2^-7 (1+2^-6) (A + |want|), A = attention of |v| in float32")

# Launches of the kernels, one per wrapper call that launched one: in all,
# and per route.
launches = 0
route_launches = dict.fromkeys(ROUTES, 0)
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0
        for name in route_launches:
            route_launches[name] = 0


def route(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The kernel a CUDA call of this dtype and head dim takes; ``aligned``:
    every base (q, k, v and the output) lies on 16 bytes."""
    if dtype == torch.float32:
        return "fma"
    return "sm90" if d % 8 == 0 and aligned else "mma_sync"


def panel_rows(t: int) -> int:
    """Q rows per online-softmax panel of the TPU kernel."""
    return t if t <= 1024 else 512


def causal_pairs(n: int, t: int) -> int:
    """Unmasked (query, key) pairs of one head under the causal mask over
    the global sequence of n blocks of t."""
    total = n * t
    return total * (total + 1) // 2


def ring_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, scale: float) -> torch.Tensor:
    """The TPU kernel's schedule on stacked (n, BH, t, d) blocks."""
    n, _, t, _ = q.shape
    cdt, f32 = q.dtype, torch.float32
    acc = torch.zeros(q.shape, dtype=f32, device=q.device)
    m = torch.full(q.shape[:-1] + (1,), M_INIT, dtype=f32, device=q.device)
    l = torch.zeros(q.shape[:-1] + (1,), dtype=f32, device=q.device)
    ranks = torch.arange(n, device=q.device).view(n, 1, 1, 1)
    keys = torch.arange(t, device=q.device).view(1, 1, 1, t)
    bq = panel_rows(t)
    kc, vc = k, v
    for step in range(n):
        kf, vf = kc.to(f32), vc.to(f32)
        kg = ((ranks - step) % n) * t + keys          # global key positions
        for qlo in range(0, t, bq):
            qs = slice(qlo, min(qlo + bq, t))
            rows = torch.arange(qs.start, qs.stop, device=q.device).view(1, 1, -1, 1)
            scores = torch.matmul(q[:, :, qs].to(f32), kf.transpose(-1, -2)) * scale
            if causal:
                scores = scores.masked_fill(ranks * t + rows < kg, -math.inf)
            m_prev = m[:, :, qs]
            m_new = torch.maximum(m_prev, scores.amax(-1, keepdim=True))
            corr = torch.exp(m_prev - m_new)
            p = torch.exp(scores - m_new)
            l[:, :, qs] = l[:, :, qs] * corr + p.sum(-1, keepdim=True)
            acc[:, :, qs] = acc[:, :, qs] * corr + torch.matmul(p.to(cdt).to(f32), vf)
            m[:, :, qs] = m_new
        if step < n - 1:                               # rank r receives from r-1
            kc, vc = kc.roll(1, 0), vc.roll(1, 0)
    return (acc / l).to(cdt)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b summed and returned in float32: bfloat16 operands on
    the card go to the tensor cores with float32 sums and a float32 result
    (as the kernel's wgmma), others are upcast."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                       scale: float) -> tuple:
    """The gradients (dq, dk, dv) of ring attention on stacked
    (n, BH, t, d) blocks, from the forward's output ``o`` and its cotangent
    ``do``: matmuls and elementwise ops, no kernel of its own.

    The forward returns no row statistics, so each query block recomputes
    its scores against the key blocks it sees (all of them, or under the
    causal mask blocks 0..r) with the kernel's rounding: float32 scores
    scaled in float32, -inf masks by global position. Then
    P = softmax(S), dV = P^T dO, dS = P * (dO V^T - rowsum(dO * O)),
    dQ = scale dS K and dK = scale dS^T Q. In bfloat16, P and dS are
    rounded to bfloat16 for their products (as the forward rounds P before
    P.V) and every product sums in float32."""
    n, bh, t, d = q.shape
    f32, cdt = torch.float32, q.dtype
    glob = lambda x: x.transpose(0, 1).reshape(bh, n * t, d)  # noqa: E731
    qg, kg, vg, dog = glob(q), glob(k), glob(v), glob(do)
    rowdot = (dog.float() * glob(o).float()).sum(-1, keepdim=True)   # (bh, nt, 1)
    dq = torch.empty(bh, n * t, d, dtype=f32, device=q.device)
    dk = torch.zeros(bh, n * t, d, dtype=f32, device=q.device)
    dv = torch.zeros(bh, n * t, d, dtype=f32, device=q.device)
    tri = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    for r in range(n):
        rows = slice(r * t, (r + 1) * t)
        keys = slice(0, (r + 1) * t if causal else n * t)
        qr, dor = qg[:, rows], dog[:, rows]
        kk, vk = kg[:, keys], vg[:, keys]
        s = _mm32(qr, kk.transpose(1, 2)) * scale
        if causal:                       # the diagonal block: keys after the row
            s[:, :, r * t:].masked_fill_(tri, -math.inf)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, keys] += _mm32(p.to(cdt).transpose(1, 2), dor)
        ds = p * (_mm32(dor, vk.transpose(1, 2)) - rowdot[:, rows])
        del p
        ds = ds.to(cdt)
        dq[:, rows] = _mm32(ds, kk) * scale
        dk[:, keys] += _mm32(ds.transpose(1, 2), qr) * scale
    back = lambda x: x.view(bh, n, t, d).transpose(0, 1).to(cdt)  # noqa: E731
    return back(dq), back(dk), back(dv)


def allowed_error(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  want: torch.Tensor, *, causal: bool, scale: float) -> torch.Tensor:
    """The largest |kernel - plain| each output element may show (float32),
    for ``want`` the plain version's output on the same inputs."""
    size = want.float().abs()
    if q.dtype != torch.bfloat16:
        atol, rtol = F32_TOLERANCE
        return atol + rtol * size
    weight = ring_attention_plain(q.float(), k.float(), v.float().abs(),
                                  causal=causal, scale=scale)
    return BF16_REL * (weight + size)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for x in (q, k, v):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"ring_attention takes tensors, got {type(x).__name__}")
    if q.dim() != 4 or q.shape[0] < 1:
        raise ValueError(f"ring_attention takes stacked (n, BH, t, d) blocks, "
                         f"got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("ring_attention: q, k and v differ in shape")
    if len({x.dtype for x in (q, k, v)}) != 1 or len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("ring_attention: q, k and v differ in dtype or device")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float, *, via: Optional[str] = None) -> torch.Tensor:
    """A kernel on stacked (n, BH, t, d) CUDA blocks, or a refusal. ``via``
    names a route in place of :func:`route`'s choice (for measurement: the
    kernel must take the call)."""
    n, bh, t, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"ring_attention: no kernel for device {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"ring_attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"ring_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("ring_attention kernel takes contiguous blocks")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    way = via or route(q.dtype, d, all(p % 16 == 0 for p in ptrs))
    if way == "sm90":
        _build.call(LIBRARY_SM90.fn("tmt_ring_attention_sm90"), q.device,
                    "ring_attention", *ptrs, n, bh, t, d, scale, int(causal))
    else:
        _build.call(LIBRARY.fn("tmt_ring_attention"), q.device, "ring_attention",
                    *ptrs, n, bh, t, d, scale, int(causal), DTYPE_CODE[q.dtype])
    global launches
    with _count_lock:
        launches += 1
        route_launches[way] += 1
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
           scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention of stacked (n, BH, t, d) blocks, any t: the kernel on
    a CUDA tensor, the plain schedule on a CPU tensor. ``scale`` defaults to
    ``1/sqrt(d)``."""
    _check(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cpu":
        return ring_attention_plain(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, scale)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False) -> torch.Tensor:
    """The TPU wrapper's contract on stacked blocks: (n, t, d) or
    (n, BH, t, d), ``t`` a multiple of 8, scale ``1/sqrt(d)``."""
    t = q.shape[-2] if q.dim() >= 2 else 0
    if t % SUBLANE:
        raise ValueError(f"local seq len {t} must be a multiple of {SUBLANE}")
    if q.dim() == 3:
        return attend(q[:, None], k[:, None], v[:, None], causal=causal)[:, 0]
    return attend(q, k, v, causal=causal)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.tmt_ring_attention
    fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int


def _bind_sm90(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.tmt_ring_attention_sm90
    fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("ring_attention", SOURCE, _bind)
LIBRARY_SM90 = _build.Library("ring_attention_sm90", SOURCE_SM90, _bind_sm90)
