"""Buffers: the array-type registry and send/recv operand normalization.

Reference: MPI.jl src/buffers.jl — MPIBuffertype union (:9), MPIPtr
conversion (:13-23), @assert_minlength bounds guard (:25-31), the
Buffer(data,count,datatype) triple (:78-91) with constructors for arrays, Refs
and three SubArray flavors that auto-derive vector/subarray datatypes
(:101-117), Buffer_send for isbits scalars (:125), and the CUDA extension
(src/cuda.jl:6-28) that plugs device arrays into the same conversion.

Port mapping: a buffer is either a host numpy array (mutable, views
welcome — numpy's strided views subsume the reference's auto-derived
SubArray datatypes) or a torch tensor on an explicit device. The mutating
API accepts :class:`DeviceBuffer`, a rebinding cell holding a tensor, and
raw tensors (written in place with ``copy_``).

Device rule: ``DeviceBuffer(value)`` with no ``device=`` lands on ``cuda``,
and raises when no CUDA device is present — it never lands on the CPU
quietly. CPU tensors are had by asking for them (``device="cpu"``).

Two contracts differ from the JAX package, whose arrays are immutable:

- **Shared results are mutable now, so cells copy on write.** The
  rendezvous hands ONE result tensor to every rank, and ``setflat`` rebinds
  each rank's cell to it without a copy (the zero-copy rebind lane). Every
  mutation through a cell — ``__setitem__``, ``fill``, a partial
  ``setflat`` — therefore clones first and rebinds to the clone, so one
  rank's write never reaches its peers' results. Treat ``.value`` (and a
  slice of it) as read-only; write through the cell.
- **Persistent results alternate two slots.** A cell returned by a
  persistent ``Allreduce_init`` round holds one of the plan's two
  preallocated accumulator slots, which the fold kernel writes in place:
  round k's result stays valid until round k+2 reuses its slot.

Streams: every rank thread launches on the device's current default
stream, so a contribution written on one rank's thread is ordered before
the fold another rank's thread launches. A caller that switches a rank to
another stream owns that ordering.

Operands carried across: :func:`from_numpy` and :func:`to_numpy` move
arrays between numpy and torch, bfloat16 as its raw 16 bits in a
``uint16`` array (numpy has no bfloat16).

Overlapping operands: a write whose source overlaps its destination in
part reads the source in full first, as numpy's assignment does (a
one-sided Put, Get or accumulate whose origin views the target range of
its own window). :func:`detach_overlap` owns that rule; where the two do
not meet it is pointer arithmetic only, and a source that starts where
its destination does (the same elements) is written in place.

Send snapshots: :func:`to_wire` copies a host array or a raw tensor into
a private snapshot and marks it (:func:`is_wire_snapshot`), so a send of
a snapshot (``Sendrecv_replace`` makes one) posts it without a second
copy. numpy's own flags cannot say "private" and a tensor has no flag at
all, so the mark is explicit: a registry keyed by ``id`` whose values are
weak references to the marked arrays and tensors, so an entry dies with
its object and a recycled id never matches. A ``DeviceBuffer``'s tensor
is never marked: its cell still holds it.
"""

from __future__ import annotations

import weakref
from typing import Any, Optional

import numpy as np
import torch

from .datatypes import Datatype, to_datatype, torch_dtype
from . import error as _ec
from .error import MPIError
from .kernels.fused_reduce import overlaps

_wire_snapshots: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()


def _mark_wire_snapshot(arr: Any) -> Any:
    _wire_snapshots[id(arr)] = arr
    return arr


def is_wire_snapshot(arr: Any) -> bool:
    """True iff ``arr`` is a private copy minted by :func:`to_wire` (a host
    array or a tensor no user can hold an alias of)."""
    return _wire_snapshots.get(id(arr)) is arr


class _InPlace:
    """Sentinel for in-place collectives (src/collective.jl:1 IN_PLACE)."""

    def __repr__(self) -> str:
        return "IN_PLACE"


IN_PLACE = _InPlace()

BUFFER_NULL = None


def is_torch_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _numel(a: Any) -> int:
    return int(a.numel()) if isinstance(a, torch.Tensor) else int(np.size(a))


def itemsize(a: Any) -> int:
    """Bytes per element of a tensor or a host array."""
    return int(a.element_size()) if isinstance(a, torch.Tensor) \
        else int(a.dtype.itemsize)


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MPIError("no CUDA device is present; pass device=\"cpu\" to "
                       "run on the CPU", code=_ec.ERR_BUFFER)
    return dev


def from_numpy(arr: Any, device: Any = None, dtype: Any = None) -> torch.Tensor:
    """A fresh tensor on ``device`` (default ``cuda``) holding ``arr``.

    bfloat16 crosses as raw bits: a ``uint16`` array with
    ``dtype=torch.bfloat16``, or an ml_dtypes bfloat16 array, is
    reinterpreted, not converted. Other ``dtype`` requests convert."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(arr)
    want = torch_dtype(dtype) if dtype is not None else None
    if a.dtype.name == "bfloat16" or (want is torch.bfloat16
                                       and a.dtype == np.uint16):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=want or t.dtype, copy=True)


def to_numpy(t: Any) -> np.ndarray:
    """A host numpy copy of a tensor; bfloat16 comes back as its raw bits
    in a ``uint16`` array."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    # .cpu() is a copy only off the CPU; a CPU tensor's .numpy() would share
    t = t.detach().cpu() if t.device.type != "cpu" else t.detach().clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def as_tensor(value: Any, dtype: Any = None, device: Any = None) -> torch.Tensor:
    """``value`` as a tensor on ``device`` (default ``cuda``), converted to
    ``dtype`` when given. A tensor already of that device and dtype comes
    back as itself (no copy); anything else is a fresh tensor."""
    dev = resolve_device(device)
    want = torch_dtype(dtype) if dtype is not None else None
    if isinstance(value, DeviceBuffer):
        value = value.value
    if isinstance(value, torch.Tensor):
        return value.to(device=dev, dtype=want or value.dtype)
    if isinstance(value, np.ndarray):
        return from_numpy(value, dev, want)
    return torch.as_tensor(np.asarray(value), device=dev, dtype=want)


class DeviceBuffer:
    """A mutable cell holding a torch tensor on an explicit device.

    The analog of passing a CuArray to MPI.jl (src/cuda.jl:26-28): device data
    is a first-class communication operand. Mutation through the cell copies
    on write and rebinds (module docstring), so the mutating API (Recv!,
    Allreduce! with a recv buffer, …) works identically for host and device
    arrays while results shared across ranks stay independent.
    """

    def __init__(self, value: Any, dtype: Any = None, device: Any = None):
        self.value = as_tensor(value, dtype, device)

    # -- constructors mirroring ArrayType{T}(undef, dims) test usage ---------
    @classmethod
    def empty(cls, shape: Any, dtype: Any = np.float64,
              device: Any = None) -> "DeviceBuffer":
        dev = resolve_device(device)
        return cls(torch.zeros(shape, dtype=torch_dtype(dtype), device=dev),
                   device=dev)

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def device(self) -> torch.device:
        return self.value.device

    @property
    def size(self) -> int:
        return int(self.value.numel())

    @property
    def nbytes(self) -> int:
        return int(self.value.numel() * self.value.element_size())

    def __len__(self) -> int:
        return int(self.value.shape[0]) if self.value.dim() else 0

    def __array__(self, dtype=None, copy=None):
        out = to_numpy(self.value)
        return out.astype(dtype) if dtype is not None else out

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, val):
        v = self.value.clone()
        v[idx] = as_tensor(val, v.dtype, v.device) \
            if isinstance(val, (np.ndarray, torch.Tensor)) else val
        self.value = v

    def setflat(self, src: Any, count: Optional[int] = None) -> None:
        """Assign the first ``count`` flat elements from src."""
        v = self.value
        # Fast path: full replacement by an identically-shaped tensor of the
        # same dtype and device is a pure rebind — no device work at all.
        # This is the hot lane of the host-path collectives (the combined
        # result is handed straight back, shared by every rank's cell).
        if (isinstance(src, torch.Tensor) and src.dtype == v.dtype
                and src.shape == v.shape and src.device == v.device
                and (count is None or count == v.numel())):
            self.value = src
            return
        n = count if count is not None else _numel(src)
        t = as_tensor(src, v.dtype, v.device)
        if n == v.numel() and v.shape == t.shape:
            self.value = t
        else:
            flat = v.reshape(-1).clone()        # copy on write
            flat[:n] = t.reshape(-1)[:n]
            self.value = flat.reshape(v.shape)

    def copy(self) -> "DeviceBuffer":
        return DeviceBuffer(self.value.clone(), device=self.value.device)

    def fill(self, v: Any) -> None:
        self.value = torch.full_like(self.value, v)

    def __repr__(self) -> str:
        return f"DeviceBuffer({self.value!r})"


class Buffer:
    """(data, count, datatype) communication operand (src/buffers.jl:78-91)."""

    def __init__(self, data: Any, count: Optional[int] = None,
                 datatype: Optional[Datatype] = None):
        self.data = data
        arr = extract_array(data)
        if arr is None:
            raise MPIError(f"not a communication buffer: {type(data).__name__}",
                           code=_ec.ERR_BUFFER)
        self.count = count if count is not None else _numel(arr)
        self.datatype = datatype if datatype is not None else to_datatype(arr.dtype)

    @property
    def array(self):
        return extract_array(self.data)


def Buffer_send(x: Any) -> Buffer:
    """Normalize any send operand, incl. scalars (src/buffers.jl:125)."""
    if isinstance(x, Buffer):
        return x
    if np.isscalar(x) or isinstance(x, (int, float, complex, bool, np.generic)):
        return Buffer(np.asarray(x))
    return Buffer(x)


def extract_array(x: Any):
    """The underlying numpy array or torch tensor of an operand, or None.

    The array-type registry: numpy arrays (incl. non-contiguous views — strided
    views play the role of the reference's auto-derived SubArray datatypes,
    src/buffers.jl:101-117), torch tensors, DeviceBuffer cells, scalars, and
    nested sequences.
    """
    if isinstance(x, DeviceBuffer):
        return x.value
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return x
    if isinstance(x, (np.generic, int, float, complex, bool)):
        return np.asarray(x)
    if isinstance(x, (list, tuple)) and x and not isinstance(x[0], (list, tuple)):
        return None  # plain sequences must be wrapped explicitly to avoid surprises
    return None


def element_count(x: Any) -> int:
    arr = extract_array(x)
    if arr is None:
        raise MPIError(f"not a communication buffer: {type(x).__name__}",
                       code=_ec.ERR_BUFFER)
    return _numel(arr)


def assert_minlength(buf: Any, count: int) -> None:
    """Bounds guard; raises AssertionError like the reference's
    @assert_minlength (src/buffers.jl:25-31)."""
    n = element_count(buf)
    assert n >= count, f"buffer has {n} elements, needs at least {count}"


def is_writable(x: Any) -> bool:
    """Whether a receive can land in ``x``: a cell, a writeable host array,
    or a raw tensor (written in place)."""
    if isinstance(x, (DeviceBuffer, torch.Tensor)):
        return True
    if isinstance(x, np.ndarray):
        return x.flags.writeable
    return False


def detach_overlap(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src`` as the source of a write into ``dst``: a copy where the two
    byte ranges intersect and start at different addresses, so the source
    is read in full before ``dst`` is written; ``src`` itself otherwise
    (pointer arithmetic, no device work)."""
    if src.data_ptr() != dst.data_ptr() and overlaps(src, dst):
        return src.clone()
    return src


def write_flat(dest: Any, src: Any, count: Optional[int] = None) -> Any:
    """Write the first ``count`` flat elements of src into dest.

    dest: numpy array (strided views fine), DeviceBuffer (copy on write,
    rebinds), or a raw tensor (written in place). Returns dest.
    """
    if isinstance(dest, DeviceBuffer):
        dest.setflat(src, count)
        return dest
    if isinstance(dest, np.ndarray):
        srcarr = to_numpy(src)
        n = srcarr.size if count is None else count
        if n == dest.size and srcarr.size == dest.size:
            # strided-safe elementwise assignment
            dest[...] = srcarr.reshape(dest.shape).astype(dest.dtype, copy=False) \
                if srcarr.shape != dest.shape else srcarr.astype(dest.dtype, copy=False)
        elif dest.flags.c_contiguous:
            # contiguous: reshape(-1) is a VIEW, and direct slice assignment
            # is a memcpy — ndarray.flat's iterator assignment is ~8x slower
            # at MiB sizes, which dominates the RMA bulk path
            dest.reshape(-1)[:n] = srcarr.reshape(-1)[:n]
        else:
            # ndarray.flat is a logical C-order view regardless of the
            # underlying strides, so partial writes land at the right logical
            # positions even for reversed/transposed/F-ordered views.
            dest.flat[:n] = srcarr.reshape(-1)[:n]
        return dest
    if isinstance(dest, torch.Tensor):
        t = as_tensor(src, dest.dtype, dest.device)
        n = t.numel() if count is None else count
        if n == dest.numel() and t.numel() == dest.numel():
            dest.copy_(detach_overlap(t.reshape(dest.shape), dest))
        elif dest.is_contiguous():
            part = dest.view(-1)[:n]
            part.copy_(detach_overlap(t.reshape(-1)[:n], part))
        else:
            raise MPIError("partial write into a non-contiguous tensor",
                           code=_ec.ERR_BUFFER)
        return dest
    raise MPIError(f"cannot write into {type(dest).__name__}", code=_ec.ERR_BUFFER)


def write_range(buf: Any, off: int, new: Any) -> None:
    """Write 1-d ``new`` into the flat element range [off, off+len(new)) of
    ``buf``: a partitioned receive's partition, a neighbour's block. A
    DeviceBuffer copies on write and rebinds; a host array is written in
    place (strided views through ``.flat``); a raw tensor is written in
    place and must be contiguous, as for :func:`write_flat`."""
    if isinstance(buf, DeviceBuffer):
        v = buf.value
        flat = v.reshape(-1).clone()              # copy on write
        src = as_tensor(new, v.dtype, v.device).reshape(-1)
        flat[off:off + src.numel()] = src
        buf.value = flat.view(v.shape)
        return
    if isinstance(buf, torch.Tensor):
        if not buf.is_contiguous():
            raise MPIError("partial write into a non-contiguous tensor",
                           code=_ec.ERR_BUFFER)
        src = as_tensor(new, buf.dtype, buf.device).reshape(-1)
        part = buf.view(-1)[off:off + src.numel()]
        part.copy_(detach_overlap(src, part))
        return
    arr = extract_array(buf)
    if arr is None:
        raise MPIError(f"cannot write into {type(buf).__name__}",
                       code=_ec.ERR_BUFFER)
    src = to_numpy(new).reshape(-1)
    if arr.flags.c_contiguous:
        arr.reshape(-1)[off:off + src.size] = src
    else:
        # .flat is a logical C-order view whatever the strides;
        # reshape(-1) of a strided view would copy and drop the write
        arr.flat[off:off + src.size] = src


def resolve_attached(attached, addr: int, who: Any):
    """Resolve a dynamic-window byte address against an attach list of
    (base_addr, nbytes, buf) entries -> (buf, tensor or array, element
    offset) (src/onesided.jl:109-121 addressing contract). The base
    address is the one :func:`~tpu_mpi_torch.datatypes.Get_address` gave
    at attach time, so a ``DeviceBuffer`` cell rebound by a write since
    keeps resolving; the offset counts elements of the buffer's value."""
    addr = int(addr)
    for (base_addr, nbytes, buf) in attached:
        if base_addr <= addr < base_addr + nbytes:
            arr = extract_array(buf)
            return buf, arr, int((addr - base_addr) // itemsize(arr))
    raise MPIError(f"address {addr:#x} not attached on rank {who}",
                   code=_ec.ERR_WIN)


def clone_like(x: Any, value: Any) -> Any:
    """An operand of the same registry kind as x holding ``value``, on x's
    device. A DeviceBuffer result may share ``value`` (cells copy on
    write); a raw tensor or numpy result is a private copy."""
    if isinstance(x, DeviceBuffer):
        return DeviceBuffer(value, device=x.value.device)
    if isinstance(x, torch.Tensor):
        t = as_tensor(value, device=x.device)
        return t.clone() if t is value else t
    return np.array(to_numpy(value), copy=True)


def to_wire(x: Any, count: Optional[int] = None) -> Any:
    """A contiguous, immutable-by-convention snapshot of a send operand.

    Host arrays and raw tensors are copied (the sender may mutate them
    after a buffered Isend); a DeviceBuffer's tensor is the snapshot
    itself, because the cell copies on write — the zero-copy win of
    device-native buffers (SURVEY.md L5).

    With ``count``, host snapshots come back FLAT and OWNING (base None,
    owndata) in a single copy — downstream in-place consumers (the
    multi-process ring allreduce) key their no-second-copy fast path on
    those flags, and a flat view of a private copy would defeat it.
    """
    if isinstance(x, DeviceBuffer):
        return _flat_tensor(x.value, count)
    if isinstance(x, torch.Tensor):
        arr = x.detach().clone(memory_format=torch.contiguous_format)
        return _mark_wire_snapshot(_flat_tensor(arr, count))
    src = np.asarray(x)
    if count is None:
        arr = np.ascontiguousarray(src)
        return _mark_wire_snapshot(arr.copy() if arr is src else arr)
    out = np.ravel(src)           # view (contiguous) or owning copy
    if out.size != count:
        out = out[:count]
    if out.base is not None or out is src:
        out = out.copy()          # the single snapshot copy
    return _mark_wire_snapshot(out)


def _flat_tensor(arr: torch.Tensor, count: Optional[int]) -> torch.Tensor:
    if count is None:
        return arr
    if arr.dim() == 1 and arr.shape[0] == count:
        return arr
    flat = arr.reshape(-1)
    return flat if flat.numel() == count else flat[:count]


def wire_view(x: Any, count: Optional[int] = None) -> Any:
    """A contiguous flat VIEW of a send operand — the zero-copy sibling of
    :func:`to_wire` for contributions whose rendezvous output is always a
    FRESH array (the reduce-family fold): every rank stays blocked in the
    rendezvous until the fold has been launched on the shared stream, so
    the live buffer cannot change under the combiner, and nothing
    downstream retains the view after the pick. Falls back to
    :func:`to_wire` when a
    flat view can't be taken without a copy (non-contiguous views), so
    callers always get wire shape."""
    if isinstance(x, (DeviceBuffer, torch.Tensor)):
        arr = extract_array(x)
        if not arr.is_contiguous():
            return to_wire(x, count)
        return _flat_tensor(arr, count)
    src = np.asarray(x)
    if not src.flags.c_contiguous:
        return to_wire(x, count)
    flat = src.reshape(-1)
    if count is not None and flat.size != count:
        flat = flat[:count]
    return flat


_registered: "weakref.WeakValueDictionary[int, np.ndarray]" = \
    weakref.WeakValueDictionary()


def register_scratch(count: int, dtype: Any) -> np.ndarray:
    """A runtime-private flat host array for a plan-bound fold accumulator.
    Registered buffers are allocated once at plan creation
    (``Allreduce_init``) and reused by every round — the zero-alloc
    contract the registered fast path is built on."""
    arr = np.empty(int(count), dtype=np.dtype(dtype))
    _registered[id(arr)] = arr
    return arr


def is_registered(arr: Any) -> bool:
    """True iff ``arr`` is a runtime-private registered scratch buffer
    (safe to fold into in place; no user alias can exist)."""
    return _registered.get(id(arr)) is arr


def pinned_wire_view(x: Any, count: int) -> Optional[np.ndarray]:
    """A STABLE flat view of a host send operand, bindable once at plan
    creation: later rounds reuse the view with no per-call normalization.
    Returns None when the operand cannot be pre-bound — non-ndarray kinds
    (DeviceBuffer rebinds its tensor every round; tensors travel through
    the device lane), non-contiguous views (wire_view would copy), or object
    dtype. The caller falls back to per-call :func:`wire_view`."""
    if not isinstance(x, np.ndarray) or x.dtype == object:
        return None
    if not x.flags.c_contiguous:
        return None
    flat = x.reshape(-1)
    return flat if flat.size == count else flat[:count]


_POISON_BYTE = 0xA5


def poison_fill(buf: Any, count: Optional[int] = None) -> None:
    """Fill the first ``count`` flat elements of an origin buffer with a loud
    sentinel (strict mode, the multi-process tier's batched read epochs):
    floats and complexes become NaN, integers the repeated-0xA5 bit
    pattern, bools True — so a caller consuming a deferred Get/Fetch_and_op
    origin before the closing synchronization sees obviously-poisoned
    values instead of plausible stale data. A raw tensor is filled in
    place, a ``DeviceBuffer`` rebinds (copy on write), a host array is
    filled in place; object-dtype and other operands are left untouched."""
    arr = extract_array(buf)
    if arr is None:
        return
    total = _numel(arr)
    n = total if count is None else min(int(count), total)
    if n <= 0:
        return
    if isinstance(arr, torch.Tensor):
        dt = arr.dtype
        if dt.is_floating_point or dt.is_complex:
            val = torch.full((n,), float("nan"), dtype=dt, device=arr.device)
        elif dt == torch.bool:
            val = torch.ones(n, dtype=dt, device=arr.device)
        else:
            val = torch.full((n * arr.element_size(),), _POISON_BYTE,
                             dtype=torch.uint8, device=arr.device).view(dt)
        write_range(buf, 0, val)
        return
    dt = np.dtype(arr.dtype)
    if dt.kind == "f":
        val = dt.type(np.nan)
    elif dt.kind == "c":
        val = dt.type(complex(np.nan, np.nan))
    elif dt.kind in "iub":
        val = np.frombuffer(bytes([_POISON_BYTE]) * dt.itemsize, dtype=dt)[0]
    else:
        return
    if arr.flags.c_contiguous:
        arr.reshape(-1)[:n] = val
    else:
        arr.flat[:n] = val


# The reference's dispatch unions (src/buffers.jl:1-11) as isinstance()
# tuples; bool subclasses int, so test bools before the integer union.
MPIInteger = (int, np.int8, np.uint8, np.int16, np.uint16,
              np.int32, np.uint32, np.int64, np.uint64)
MPIFloatingPoint = (float, np.float32, np.float64, np.float16)
MPIComplex = (complex, np.complex64, np.complex128)
MPIDatatype = (bool, np.bool_) + MPIInteger + MPIFloatingPoint + MPIComplex
