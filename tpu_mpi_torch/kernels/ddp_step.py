"""The data-parallel trainer's per-step passes over its float64 state, one
launch per gradient bucket: :func:`pack` casts a bucket's gradients into
its float64 send flat, :func:`update` applies the SGD-momentum step to the
flat masters and momentum from every bucket's reduced sum.

Replaces no TPU kernel: the JAX package packs and folds with numpy on the
host (``tpu_mpi/train/bucketer.py``, ``tpu_mpi/train/ddp.py:150``). The
same work in PyTorch is a few launches a tensor, each of which releases
the interpreter lock and waits to win it back from the other rank threads;
these take a bucket, or ``SEG_MAX`` buckets, a launch.

On a CUDA tensor the wrapper launches the hand-written kernels in
``tpu_mpi_torch/csrc/ddp_step.cu``, or raises. On a CPU tensor it runs
:func:`pack_plain` / :func:`update_plain`, the PyTorch sequences beside
them, which are also the kernels' oracle on the card. Both are bitwise
equal: the pack converts as ``copy_`` does, and the update rounds once a
step in PyTorch's order (see the kernel source). The update is
elementwise, so one bucket's flat range gives the bits that the same
sequence gives a tensor at a time.

Counts: ``ddp_pack_launches`` and ``ddp_update_launches``, the kernels
each launched (as the C side reports them: one a chunk of up to ``SEG_MAX``
segments that holds an element), and ``ddp_pack_copies``, the gradients
:func:`pack` had PyTorch copy first because the kernel cannot read them
where they are (off ``dst``'s device, of another type, or non-contiguous).
"""

from __future__ import annotations

import ctypes
from typing import Any, Sequence, Tuple

import torch

from . import _build
from .fold_ops import DTYPE_CODE

SOURCE = _build.CSRC / "ddp_step.cu"

SEG_MAX = 32        # segments one launch takes (SEG_MAX in the kernel source)

# Gradient types the pack kernel converts; any other is cast by PyTorch first.
PACK_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16)


Part = Tuple[int, int, torch.Tensor]      # (offset, count, tensor)


def pack_plain(dst: torch.Tensor, parts: Sequence[Part]) -> None:
    """The plain pack: each tensor copied into ``dst[off : off + n]``."""
    for off, n, g in parts:
        dst.narrow(0, off, n).copy_(g.detach().reshape(-1))


def pack(dst: torch.Tensor, parts: Sequence[Part]) -> None:
    """Copy each ``(off, n, g)`` part's tensor ``g`` of ``n`` elements, of
    any shape and type, into ``dst[off : off + n]`` of the contiguous
    float64 flat ``dst``, converted to float64. On a CUDA ``dst`` one
    launch (chained beyond ``SEG_MAX`` parts) on the current stream; a
    tensor off ``dst``'s device or of a type the kernel does not convert is
    cast there by PyTorch first, a non-contiguous one made contiguous, each
    counted in ``ddp_pack_copies``."""
    for off, n, g in parts:
        if g.numel() != n or off < 0 or off + n > dst.numel():
            raise ValueError(f"ddp pack: a {g.numel()}-element gradient for "
                             f"[{off}, {off + n}) of a {dst.numel()}-element flat")
    if dst.dtype != torch.float64 or not dst.is_contiguous():
        raise ValueError("ddp pack: dst must be a contiguous float64 flat")
    if dst.device.type == "cpu":
        pack_plain(dst, parts)
        return
    if dst.device.type != "cuda":
        raise ValueError(f"ddp pack: no kernel for device {dst.device}")
    if not parts:
        return
    srcs, copies = [], 0
    for _, _, g in parts:
        if g.device != dst.device or g.dtype not in PACK_DTYPES:
            g, copies = g.to(device=dst.device, dtype=torch.float64), copies + 1
        elif not g.is_contiguous():
            g, copies = g.contiguous(), copies + 1
        srcs.append(g)
    n = len(parts)
    _build.counts.add("ddp_pack_copies", n=copies)
    _launch("tmt_ddp_pack", "ddp_pack_launches", dst.device, "ddp pack",
            (ctypes.c_void_p * n)(*[g.data_ptr() for g in srcs]),
            (ctypes.c_int * n)(*[DTYPE_CODE[g.dtype] for g in srcs]),
            (ctypes.c_int64 * n)(*[off for off, _, _ in parts]),
            (ctypes.c_int64 * n)(*[c for _, c, _ in parts]),
            n, dst.data_ptr())


def update_plain(master: torch.Tensor, momentum: torch.Tensor,
                 parts: Sequence[Part], inv: float, mu: float, lr: float) -> None:
    """The plain update: per part, the reduced sum ``r`` of
    ``master[off : off + n]``'s gradient, in PyTorch's per-tensor order
    (``r`` is read only: ranks may share it)."""
    for off, n, r in parts:
        g = r.reshape(-1) * inv                  # mean gradient (own tensor)
        m = momentum.narrow(0, off, n)
        m.mul_(mu).add_(g)
        master.narrow(0, off, n).sub_(torch.mul(m, lr, out=g))


def update(master: torch.Tensor, momentum: torch.Tensor, parts: Sequence[Part],
           inv: float, mu: float, lr: float) -> None:
    """SGD with momentum on the contiguous float64 flats ``master`` and
    ``momentum``, from each ``(off, n, r)`` part's reduced sum ``r``
    (``n`` float64 elements) of ``[off, off + n)``: ``g = r * inv; m = m *
    mu + g; p = p - m * lr``, one rounding a step. On CUDA flats
    ``ceil(len(parts) / SEG_MAX)`` launches on the current stream."""
    for t in (master, momentum):
        if t.dtype != torch.float64 or not t.is_contiguous():
            raise ValueError("ddp update: master and momentum must be contiguous "
                             "float64 flats")
    if momentum.device != master.device or momentum.numel() != master.numel():
        raise ValueError("ddp update: master and momentum differ in device or size")
    for off, n, r in parts:
        if r.numel() != n or off < 0 or off + n > master.numel():
            raise ValueError(f"ddp update: a {r.numel()}-element sum for "
                             f"[{off}, {off + n}) of a {master.numel()}-element flat")
    if master.device.type == "cpu":
        update_plain(master, momentum, parts, inv, mu, lr)
        return
    if master.device.type != "cuda":
        raise ValueError(f"ddp update: no kernel for device {master.device}")
    if not parts:
        return
    for _, _, r in parts:
        if r.device != master.device or r.dtype != torch.float64 \
                or not r.is_contiguous():
            raise ValueError("ddp update kernel takes contiguous float64 sums on "
                             "the masters' device")
    n = len(parts)
    _launch("tmt_ddp_update", "ddp_update_launches", master.device, "ddp update",
            (ctypes.c_void_p * n)(*[r.data_ptr() for _, _, r in parts]),
            (ctypes.c_int64 * n)(*[off for off, _, _ in parts]),
            (ctypes.c_int64 * n)(*[c for _, c, _ in parts]),
            n, master.data_ptr(), momentum.data_ptr(),
            float(inv), float(mu), float(lr))


def _launch(fn: str, counter: str, device: torch.device, what: str, *args) -> None:
    """Call the C function ``fn`` with ``args``, its launch count's
    address and the stream, and add the kernels it launched to the count
    ``counter``, a refused call's earlier launches included."""
    launched = ctypes.c_int(0)
    try:
        _build.call(LIBRARY.fn(fn), device, what, *args, ctypes.byref(launched))
    finally:
        _build.counts.add(counter, n=launched.value)


def _bind(lib: ctypes.CDLL) -> None:
    pack_fn = lib.tmt_ddp_pack
    pack_fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                        ctypes.c_void_p]
    pack_fn.restype = ctypes.c_int
    update_fn = lib.tmt_ddp_update
    update_fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
                          ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                          ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_int),
                          ctypes.c_void_p]
    update_fn.restype = ctypes.c_int


LIBRARY = _build.Library("ddp_step", SOURCE, _bind)
