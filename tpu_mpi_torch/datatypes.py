"""Datatypes: dtype mapping plus derived-layout descriptors.

Reference: MPI.jl src/datatypes.jl — Datatype handle (:16), table of 23
predefined MPI↔Julia types (:29-60), the MPI.Types submodule: extent (:77-86),
create_contiguous (:99-107), create_vector (:142-152), create_subarray
(:171-190), create_struct (:203-221), create_resized (:241-251), commit!
(:262-266), and the automatic recursive ``Datatype(T)`` for any isbits struct
(:269-316) that walks field offsets, coalesces adjacent equal fields and
decomposes odd sizes into UInt blocks.

Port mapping: torch dtypes map onto the same predefined datatypes
(:func:`torch_dtype` and ``to_datatype(torch.float32)``). Two traps: numpy
has no bfloat16, so BFLOAT16 travels as its raw 16 bits where ml_dtypes is
absent; and torch has only partial arithmetic on uint16/uint32/uint64 (no
add or compare kernels), so the reduction operators fold those types through
their signed views (:mod:`tpu_mpi_torch.operators`) and the kernels take
them as types of their own, both bitwise as numpy and the JAX package fold.

TPU mapping (SURVEY.md §2.2): a datatype = (numpy dtype, layout) descriptor.
XLA owns physical layout, so vector/subarray become strided/sliced element maps
used to pack to and unpack from contiguous wire buffers; struct types map to
numpy structured dtypes; the isbits auto-derivation becomes recursive structured
-dtype construction from dataclasses / NamedTuples / nested numpy records.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from . import error as _ec
from .error import MPIError


class Datatype:
    """A wire-format descriptor.

    ``blocks`` is a flat list of ``(byte_offset, numpy_dtype, count)`` runs
    within one extent — the same normal form the reference builds for isbits
    structs (src/datatypes.jl:269-316). ``extent`` is the stride between
    consecutive elements in a buffer; ``size`` is the number of payload bytes.
    """

    def __init__(self, np_dtype: Optional[np.dtype] = None, *,
                 blocks: Optional[list[tuple[int, np.dtype, int]]] = None,
                 extent: Optional[int] = None, lb: int = 0,
                 name: str = "datatype", committed: bool = True):
        if np_dtype is not None:
            np_dtype = np.dtype(np_dtype)
            if blocks is None:
                blocks = _blocks_from_np_dtype(np_dtype)
            if extent is None:
                extent = np_dtype.itemsize
        if blocks is None:
            raise MPIError("datatype needs an np_dtype or explicit blocks",
                           code=_ec.ERR_TYPE)
        self.np_dtype = np_dtype            # None for non-record derived layouts
        self.blocks = blocks
        self.lb = lb
        self.extent_bytes = extent if extent is not None else _blocks_span(blocks)
        self.size_bytes = sum(dt.itemsize * c for (_, dt, c) in blocks)
        self.name = name
        self.committed = committed
        self._freed = False

    # -- queries -------------------------------------------------------------
    def extent(self) -> tuple[int, int]:
        """(lower bound, extent) in bytes (src/datatypes.jl:77-86)."""
        return (self.lb, self.extent_bytes)

    @property
    def is_primitive(self) -> bool:
        return (self.np_dtype is not None and self.np_dtype.fields is None
                and len(self.blocks) == 1 and self.blocks[0] == (0, self.np_dtype, 1))

    # -- pack/unpack: derived layout <-> contiguous wire bytes ---------------
    def pack(self, raw: memoryview, count: int, base_offset: int = 0) -> bytes:
        """Gather ``count`` elements of this layout from raw bytes."""
        out = bytearray(self.size_bytes * count)
        pos = 0
        for i in range(count):
            elem = base_offset + self.lb + i * self.extent_bytes
            for (off, dt, c) in self.blocks:
                n = dt.itemsize * c
                out[pos:pos + n] = raw[elem + off: elem + off + n]
                pos += n
        return bytes(out)

    def unpack(self, wire: memoryview, raw: memoryview, count: int,
               base_offset: int = 0) -> None:
        """Scatter ``count`` packed elements back into raw bytes."""
        pos = 0
        for i in range(count):
            elem = base_offset + self.lb + i * self.extent_bytes
            for (off, dt, c) in self.blocks:
                n = dt.itemsize * c
                raw[elem + off: elem + off + n] = wire[pos: pos + n]
                pos += n

    def free(self) -> None:
        self._freed = True

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Datatype) and self.blocks == other.blocks
                and self.extent_bytes == other.extent_bytes and self.lb == other.lb)

    def __hash__(self) -> int:
        return hash((tuple(self.blocks), self.extent_bytes, self.lb))

    def __repr__(self) -> str:
        return f"<Datatype {self.name} size={self.size_bytes} extent={self.extent_bytes}>"


def _blocks_from_np_dtype(dt: np.dtype, base: int = 0) -> list[tuple[int, np.dtype, int]]:
    """Flatten a (possibly structured / sub-arrayed) numpy dtype into runs —
    the analog of the recursive field walk in src/datatypes.jl:276-316."""
    if dt.fields is None:
        if dt.subdtype is not None:
            sub, shape = dt.subdtype
            n = int(np.prod(shape))
            inner = _blocks_from_np_dtype(sub)
            if len(inner) == 1 and inner[0][0] == 0:
                off, idt, c = inner[0]
                return [(base, idt, c * n)]
            out = []
            for i in range(n):
                for (off, idt, c) in inner:
                    out.append((base + i * sub.itemsize + off, idt, c))
            return out
        return [(base, dt, 1)]
    out: list[tuple[int, np.dtype, int]] = []
    for fname in dt.names:
        fdt, foff = dt.fields[fname][:2]
        out.extend(_blocks_from_np_dtype(fdt, base + foff))
    # Coalesce adjacent equal-dtype runs (src/datatypes.jl:283-292).
    return _coalesce(out)


# -- predefined datatypes (src/datatypes.jl:29-60) ----------------------------
def _predef(np_type: Any, name: str) -> Datatype:
    return Datatype(np.dtype(np_type), name=name)


INT8 = _predef(np.int8, "INT8")
INT16 = _predef(np.int16, "INT16")
INT32 = _predef(np.int32, "INT32")
INT64 = _predef(np.int64, "INT64")
UINT8 = _predef(np.uint8, "UINT8")
UINT16 = _predef(np.uint16, "UINT16")
UINT32 = _predef(np.uint32, "UINT32")
UINT64 = _predef(np.uint64, "UINT64")
FLOAT16 = _predef(np.float16, "FLOAT16")
FLOAT32 = _predef(np.float32, "FLOAT32")
FLOAT64 = _predef(np.float64, "FLOAT64")
COMPLEX64 = _predef(np.complex64, "COMPLEX64")
COMPLEX128 = _predef(np.complex128, "COMPLEX128")
BOOL = _predef(np.bool_, "BOOL")
BYTE = _predef(np.uint8, "BYTE")
CHAR = _predef(np.uint32, "CHAR")       # Julia Char is UInt32 (src/datatypes.jl:44)
try:
    BFLOAT16 = Datatype(np.dtype("bfloat16"), name="BFLOAT16")
except TypeError:
    try:
        import ml_dtypes
        BFLOAT16 = Datatype(np.dtype(ml_dtypes.bfloat16), name="BFLOAT16")
    except ImportError:
        # numpy has no bfloat16: without ml_dtypes the wire form is the raw
        # 16 bits as uint16 (buffers.to_numpy / from_numpy use the same view)
        BFLOAT16 = Datatype(np.dtype(np.uint16), name="BFLOAT16")

_PY_MAP = {int: INT64, float: FLOAT64, complex: COMPLEX128, bool: BOOL}


_DTYPE_CACHE: dict = {}      # plain np.dtype -> Datatype (per-message hot path)


def to_datatype(T: Any) -> Datatype:
    """``Datatype(T)`` for a Python/numpy/dataclass type (src/datatypes.jl:269-316)."""
    if isinstance(T, Datatype):
        return T
    if isinstance(T, torch.dtype):
        dt = _TORCH_TO_DATATYPE.get(T)
        if dt is None:
            raise MPIError(f"no wire datatype for {T}", code=_ec.ERR_TYPE)
        return dt
    if isinstance(T, np.dtype):
        # every typed send resolves its array's dtype here — memoize the
        # handful of plain dtypes (structured dtypes skip the cache: their
        # identity can embed mutable field metadata)
        if T.names is None:
            dt = _DTYPE_CACHE.get(T)
            if dt is None:
                dt = Datatype(T, name=str(T))
                _DTYPE_CACHE[T] = dt
            return dt
    if T in _PY_MAP:
        return _PY_MAP[T]
    if dataclasses.is_dataclass(T) or (isinstance(T, type) and issubclass(T, tuple)
                                       and hasattr(T, "_fields")):
        return Datatype(struct_np_dtype(T), name=getattr(T, "__name__", "struct"))
    try:
        return Datatype(np.dtype(T), name=str(np.dtype(T)))
    except TypeError:
        raise MPIError(f"no wire datatype for {T!r}", code=_ec.ERR_TYPE) from None


def struct_np_dtype(T: Any) -> np.dtype:
    """Recursive structured-dtype construction for dataclasses / NamedTuples —
    the auto isbits derivation (src/datatypes.jl:269-316) done the numpy way."""
    if dataclasses.is_dataclass(T):
        items = [(f.name, f.type) for f in dataclasses.fields(T)]
    elif isinstance(T, type) and issubclass(T, tuple) and hasattr(T, "_fields"):
        hints = T.__annotations__
        items = [(n, hints[n]) for n in T._fields]
    else:
        raise MPIError(f"not a struct-like type: {T!r}", code=_ec.ERR_TYPE)
    fields = []
    for name, ftype in items:
        if dataclasses.is_dataclass(ftype) or (isinstance(ftype, type)
                                               and issubclass(ftype, tuple)
                                               and hasattr(ftype, "_fields")):
            fields.append((name, struct_np_dtype(ftype)))
        elif ftype in _PY_MAP:
            fields.append((name, _PY_MAP[ftype].np_dtype))
        else:
            fields.append((name, np.dtype(ftype)))
    return np.dtype(fields, align=True)   # align=True keeps C padding like isbits


class Types:
    """Derived-datatype constructors (the MPI.Types submodule)."""

    @staticmethod
    def extent(dt: Datatype) -> tuple[int, int]:
        return dt.extent()

    @staticmethod
    def create_contiguous(count: int, base: Datatype) -> Datatype:
        """count consecutive elements (src/datatypes.jl:99-107)."""
        blocks: list[tuple[int, np.dtype, int]] = []
        for i in range(count):
            for (off, dt, c) in base.blocks:
                blocks.append((i * base.extent_bytes + base.lb + off, dt, c))
        return Datatype(blocks=_coalesce(blocks), extent=count * base.extent_bytes,
                        name=f"contiguous({count},{base.name})", committed=False)

    @staticmethod
    def create_vector(count: int, blocklength: int, stride: int,
                      base: Datatype) -> Datatype:
        """count blocks of blocklength elements, stride elements apart
        (src/datatypes.jl:142-152)."""
        blocks: list[tuple[int, np.dtype, int]] = []
        for i in range(count):
            start = i * stride * base.extent_bytes
            for j in range(blocklength):
                for (off, dt, c) in base.blocks:
                    blocks.append((start + j * base.extent_bytes + base.lb + off, dt, c))
        extent = ((count - 1) * stride + blocklength) * base.extent_bytes if count else 0
        return Datatype(blocks=_coalesce(blocks), extent=extent,
                        name=f"vector({count},{blocklength},{stride})", committed=False)

    @staticmethod
    def create_subarray(sizes: Sequence[int], subsizes: Sequence[int],
                        offsets: Sequence[int], base: Datatype,
                        order: str = "C") -> Datatype:
        """N-d subarray of a larger array (src/datatypes.jl:171-190);
        order 'C' (row-major) or 'F' (column-major, the Julia default)."""
        sizes = tuple(int(s) for s in sizes)
        subsizes = tuple(int(s) for s in subsizes)
        offsets = tuple(int(s) for s in offsets)
        idx = np.meshgrid(*[np.arange(o, o + s) for o, s in zip(offsets, subsizes)],
                          indexing="ij")
        flat = np.ravel_multi_index([i.reshape(-1) for i in idx], sizes, order=order)
        flat = np.sort(flat)
        blocks: list[tuple[int, np.dtype, int]] = []
        for k in flat.tolist():
            start = k * base.extent_bytes
            for (off, dt, c) in base.blocks:
                blocks.append((start + base.lb + off, dt, c))
        extent = int(np.prod(sizes)) * base.extent_bytes
        return Datatype(blocks=_coalesce(blocks), extent=extent,
                        name=f"subarray({subsizes}of{sizes})", committed=False)

    @staticmethod
    def create_struct(blocklengths: Sequence[int], displacements: Sequence[int],
                      types: Sequence[Datatype]) -> Datatype:
        """General struct layout (src/datatypes.jl:203-221)."""
        blocks: list[tuple[int, np.dtype, int]] = []
        upper = 0
        for bl, disp, t in zip(blocklengths, displacements, types):
            for i in range(bl):
                for (off, dt, c) in t.blocks:
                    blocks.append((disp + i * t.extent_bytes + t.lb + off, dt, c))
            upper = max(upper, disp + bl * t.extent_bytes)
        return Datatype(blocks=_coalesce(blocks), extent=upper,
                        name="struct", committed=False)

    @staticmethod
    def create_resized(base: Datatype, lb: int, extent: int) -> Datatype:
        """Override lb/extent (src/datatypes.jl:241-251)."""
        return Datatype(blocks=list(base.blocks), extent=extent, lb=lb,
                        name=f"resized({base.name})", committed=False)

    @staticmethod
    def commit(dt: Datatype) -> Datatype:
        """Finalize a derived type for use (src/datatypes.jl:262-266)."""
        dt.committed = True
        return dt


def _coalesce(blocks: list[tuple[int, np.dtype, int]]) -> list[tuple[int, np.dtype, int]]:
    merged: list[tuple[int, np.dtype, int]] = []
    for blk in sorted(blocks, key=lambda b: b[0]):
        if merged:
            poff, pdt, pc = merged[-1]
            off, bdt, c = blk
            if pdt == bdt and poff + pdt.itemsize * pc == off:
                merged[-1] = (poff, pdt, pc + c)
                continue
        merged.append(blk)
    return merged


def Get_address(obj: Any) -> int:
    """Address of a buffer (src/datatypes.jl:321-325): a tensor's
    ``data_ptr()`` (on the CPU and on CUDA alike), a ``DeviceBuffer``'s
    tensor's — stable while nothing writes the cell, which rebinds on
    write — and a host array's data pointer."""
    value = getattr(obj, "value", obj)      # a DeviceBuffer's tensor
    if isinstance(value, torch.Tensor):
        return int(value.data_ptr())
    arr = np.asarray(obj)
    return arr.__array_interface__["data"][0]


# torch dtype <-> predefined Datatype. BYTE and CHAR alias UINT8 and UINT32
# on the wire, so they map one way only.
_TORCH_TO_DATATYPE = {
    torch.int8: INT8, torch.int16: INT16, torch.int32: INT32,
    torch.int64: INT64, torch.uint8: UINT8, torch.uint16: UINT16,
    torch.uint32: UINT32, torch.uint64: UINT64, torch.float16: FLOAT16,
    torch.float32: FLOAT32, torch.float64: FLOAT64,
    torch.complex64: COMPLEX64, torch.complex128: COMPLEX128,
    torch.bool: BOOL, torch.bfloat16: BFLOAT16,
}
_NP_TO_TORCH = {dt.np_dtype: t for t, dt in _TORCH_TO_DATATYPE.items()
                if t is not torch.bfloat16}


def torch_dtype(T: Any) -> torch.dtype:
    """The torch dtype of a Datatype, numpy dtype, torch dtype or Python
    type (``np.float32`` -> ``torch.float32``; ``BFLOAT16`` and an
    ml_dtypes bfloat16 -> ``torch.bfloat16``)."""
    if isinstance(T, torch.dtype):
        return T
    if T is BFLOAT16:
        return torch.bfloat16
    npdt = T.np_dtype if isinstance(T, Datatype) else np.dtype(T)
    if npdt is not None and npdt.name == "bfloat16":
        return torch.bfloat16
    t = _NP_TO_TORCH.get(npdt)
    if t is None:
        raise MPIError(f"no torch dtype for {T!r}", code=_ec.ERR_TYPE)
    return t
