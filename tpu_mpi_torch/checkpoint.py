"""Sharded checkpoint/resume built on the collective File layer — the port
of ``tpu_mpi/checkpoint.py``, writing the same file format.

`MPI.File` collective I/O is the substrate applications build checkpoints
from (/root/reference/src/io.jl is the whole surface); this module is that
application layer, provided in-tree: every rank contributes its LOCAL tree
of arrays (a dp-sharded optimizer state, a pipeline stage's parameters, …)
and the world collectively writes ONE coherent file:

    [magic u64][header_len u64][pickled header][rank 0 data][rank 1 data]…

The header (written by rank 0) records every rank's tree structure, dtypes,
shapes and byte offsets, so a restarted job — or an offline reader — can
locate any shard. Shard data moves with independent `File.write_at` /
`read_at` at header-computed offsets (leaf counts may differ per rank, so
the collective `_all` variants don't fit); a closing `Barrier` is the
completion point.

    from tpu_mpi_torch import checkpoint
    checkpoint.save_sharded(path, {"w": w, "step": step}, comm)
    state = checkpoint.load_sharded(path, comm)

Leaves may be numpy arrays, tensors or ``DeviceBuffer``s on any device;
each is staged to host once. Arrays come back as numpy (device placement
is the caller's policy: ``DeviceBuffer(state["w"])``).

The file is the JAX package's, byte for byte, for the same tree: the
pickled header holds only Python builtins and numpy dtype strings (a shape
is a tuple of ints, never a ``torch.Size``), so either package reads the
other's files; a bfloat16 leaf is recorded as the JAX package records an
ml_dtypes bfloat16 array, ``'<V2'`` with its raw bits, and reads back as
2-byte void records.
"""

from __future__ import annotations

import os
import pickle
import zlib
from typing import Any

import numpy as np
import torch

from . import io as File
from .buffers import extract_array
from .collective import Barrier, _run
from .comm import Comm
from . import error as _ec
from .error import MPIError

# v2: 32-byte fixed head [magic u64][hdr_cap u64][hdr_len u64][hdr_crc u32]
# [pad u32], CRC32 over the unpadded pickled header, per-leaf payload CRCs
# in the header, and writes go to a temp file atomically renamed into place
# — a torn write (killed rank, full disk) can never masquerade as a valid
# checkpoint.
_MAGIC = 0x7D5AC4B7_00000002
_MAGIC_V1 = 0x7D5AC4B7_00000001
_HEAD = 32


def _esc(key: str) -> str:
    """Escape the path separator in dict keys: a key containing '/' must
    not collide with nested structure ("a/b" vs {"a": {"b": ...}})."""
    return str(key).replace("\\", "\\\\").replace("/", "\\/")


def _host_leaf(arr: Any) -> tuple[np.ndarray, Any]:
    """A leaf as a host array (a tensor staged once) and the dtype the
    header records for it."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        t = t.cpu() if t.device.type != "cpu" else t
        if t.dtype == torch.bfloat16:
            # what numpy records for an ml_dtypes bfloat16 array: void
            # records of its width ('<V2'), a fresh string per leaf as
            # numpy's dtype.str is — pickle memoizes by identity, so a
            # shared constant would change the header's bytes
            return (t.view(torch.int16).numpy().view(np.uint16),
                    "<V%d" % t.element_size())
        a = t.numpy()
    else:
        a = np.asarray(arr)
    return a, a.dtype.str if a.dtype.names is None else a.dtype.descr


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, np.ndarray, Any]]:
    """Deterministic (key, host array, recorded dtype) leaves of a nested
    dict/list/tuple tree."""
    out: list[tuple[str, np.ndarray, Any]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{_esc(k)}/"))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{prefix}{i}/"))
        return out
    arr = extract_array(tree)
    if arr is None:
        raise MPIError(f"checkpoint leaf {prefix[:-1]!r} is not an array "
                       f"({type(tree).__name__})", code=_ec.ERR_ARG)
    if isinstance(arr, np.ndarray) and arr.dtype.hasobject:
        # must fail HERE, before any collective: a raw ValueError later in
        # the write loop would strand the other ranks mid-rendezvous
        raise MPIError(f"checkpoint leaf {prefix[:-1]!r} has object dtype "
                       f"{arr.dtype} (not storable as raw bytes)",
                       code=_ec.ERR_ARG)
    host, dt = _host_leaf(arr)
    return [(prefix[:-1], host, dt)]


def _unflatten(spec: Any, leaves: dict[str, np.ndarray], prefix: str = ""):
    if isinstance(spec, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{_esc(k)}/")
                for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        seq = [_unflatten(v, leaves, f"{prefix}{i}/")
               for i, v in enumerate(spec)]
        return type(spec)(seq) if isinstance(spec, tuple) else seq
    return leaves[prefix[:-1]]


def _tree_spec(tree: Any):
    """Structure with leaves replaced by None (pickled into the header)."""
    if isinstance(tree, dict):
        return {k: _tree_spec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_tree_spec(v) for v in tree]
        return tuple(seq) if isinstance(tree, tuple) else seq
    return None


def save_sharded(path: str, tree: Any, comm: Comm) -> None:
    """Collectively write every rank's local ``tree`` into one file.

    Torn-write hardening: all ranks write a temp file next to ``path``;
    after every shard is synced, rank 0 atomically renames it into place.
    A reader never observes a half-written checkpoint — either the old
    file or the complete new one. Header and every leaf payload carry
    CRC32s that ``load_sharded`` verifies."""
    rank, size = comm.rank(), comm.size()
    leaves = _flatten(tree)
    flats = [np.ascontiguousarray(a).reshape(-1).view(np.uint8)
             for _, a, _ in leaves]
    my_meta = (_tree_spec(tree),
               # structured dtypes keep their field layout via descr;
               # trailing field: CRC32 of the leaf's raw bytes
               [(k, dt, tuple(int(s) for s in a.shape), int(a.nbytes),
                 zlib.crc32(f))
                for (k, a, dt), f in zip(leaves, flats)])
    # allgather of python meta objects (dynamic sizes) via the rendezvous
    all_metas = _run(comm, my_meta, lambda cs: [list(cs)] * len(cs),
                     f"ckpt_meta@{comm.cid}")

    header = {"magic": _MAGIC, "ranks": [
        {"spec": spec, "leaves": leafmeta, "offset": 0}
        for (spec, leafmeta) in all_metas]}
    # offsets depend on the header length which depends on the offsets'
    # pickled width — break the cycle by padding the header to a stable
    # capacity (every rank computes the identical value)
    hdr_cap = len(pickle.dumps(header)) + 16 * size + 64
    off = _HEAD + hdr_cap
    for r, (spec, leafmeta) in enumerate(all_metas):
        header["ranks"][r]["offset"] = off
        off += sum(m[3] for m in leafmeta)
    hdr = pickle.dumps(header)
    if len(hdr) > hdr_cap:
        raise MPIError("checkpoint header overflow (internal)",
                       code=_ec.ERR_INTERN)
    hdr_len, hdr_crc = len(hdr), zlib.crc32(hdr)
    hdr = hdr + b"\x00" * (hdr_cap - hdr_len)

    tmp = path + ".tmp"
    if rank == 0 and os.path.exists(tmp):
        os.unlink(tmp)      # a stale temp from a killed job must not linger
    Barrier(comm)
    fh = File.open(comm, tmp, write=True, create=True)
    try:
        if rank == 0:
            head = np.frombuffer(
                _MAGIC.to_bytes(8, "little") + hdr_cap.to_bytes(8, "little")
                + hdr_len.to_bytes(8, "little") + hdr_crc.to_bytes(4, "little")
                + b"\x00" * 4 + hdr, np.uint8)
            File.write_at(fh, 0, head)
        my_off = header["ranks"][rank]["offset"]
        # independent (non-collective) writes: leaf COUNTS may differ per
        # rank, and write_at_all requires matched call sequences; the
        # closing Barrier is the completion point
        for flat in flats:
            File.write_at(fh, my_off, flat)
            my_off += flat.nbytes
        File.sync(fh)
    finally:
        File.close(fh)
    Barrier(comm)
    if rank == 0:
        os.replace(tmp, path)   # the atomic publication point
    Barrier(comm)


def _read_head(fh, path: str, fsize: int) -> tuple[int, int, int]:
    """(hdr_cap, hdr_len, hdr_crc) of a v2 file; raises on anything else."""
    if fsize < _HEAD:
        raise MPIError(
            f"{path!r} is truncated ({fsize} bytes; no checkpoint head)",
            code=_ec.ERR_FILE)
    head = np.zeros(_HEAD, np.uint8)
    File.read_at(fh, 0, head)
    magic = int.from_bytes(head[:8].tobytes(), "little")
    if magic == _MAGIC_V1:
        raise MPIError(
            f"{path!r} is a v1 sharded checkpoint (no integrity "
            f"metadata); re-save it with this version",
            code=_ec.ERR_FILE)
    if magic != _MAGIC:
        raise MPIError(f"{path!r} is not a tpu_mpi sharded checkpoint",
                       code=_ec.ERR_FILE)
    hdr_cap = int.from_bytes(head[8:16].tobytes(), "little")
    hdr_len = int.from_bytes(head[16:24].tobytes(), "little")
    hdr_crc = int.from_bytes(head[24:28].tobytes(), "little")
    # bound the header-capacity field by the actual file size before
    # allocating: a truncated/corrupt file with valid magic must fail
    # cleanly, not trigger an arbitrary-size allocation
    if (hdr_cap <= 0 or _HEAD + hdr_cap > fsize
            or not (0 < hdr_len <= hdr_cap)):
        raise MPIError(
            f"corrupt checkpoint header: capacity {hdr_cap} / length "
            f"{hdr_len} inconsistent with file size {fsize}",
            code=_ec.ERR_FILE)
    return hdr_cap, hdr_len, hdr_crc


def shard_count(path: str, comm: Comm) -> int:
    """Number of rank shards in a save_sharded file (collective over
    ``comm`` only in that every caller may open the file; no rendezvous).
    The restore path uses this to re-partition a checkpoint written by a
    communicator of another size."""
    fh = File.open(comm, path, read=True)
    try:
        fsize = File.get_size(fh)
        try:
            hdr_cap, hdr_len, _ = _read_head(fh, path, fsize)
        except MPIError:
            raise MPIError(f"{path!r} is not a readable tpu_mpi sharded "
                           f"checkpoint", code=_ec.ERR_FILE) from None
        raw = np.zeros(hdr_cap, np.uint8)
        File.read_at(fh, _HEAD, raw)
        try:
            return len(pickle.loads(raw[:hdr_len].tobytes())["ranks"])
        except Exception as e:
            raise MPIError(
                f"undecodable checkpoint header in {path!r}: "
                f"{type(e).__name__}: {e}", code=_ec.ERR_FILE) from None
    finally:
        File.close(fh)


def load_sharded(path: str, comm: Comm, *, shard: int | None = None) -> Any:
    """Collectively restore this rank's tree from a save_sharded file.

    ``shard`` overrides which rank shard this caller reads (default: its
    own comm rank, requiring the comm size to match the writer's). The
    override exists for restores on another world size: each rank re-reads
    whichever shards its new partition covers.

    Trust model: the header is a pickle — loading executes code, exactly
    like ``np.load(allow_pickle=True)`` or a torch checkpoint. Only load
    checkpoints your own job (or another trusted writer) produced.
    """
    rank, size = comm.rank(), comm.size()
    fh = File.open(comm, path, read=True)
    try:
        fsize = File.get_size(fh)
        hdr_cap, hdr_len, hdr_crc = _read_head(fh, path, fsize)
        raw = np.zeros(hdr_cap, np.uint8)
        File.read_at(fh, _HEAD, raw)
        hdr_bytes = raw[:hdr_len].tobytes()
        if zlib.crc32(hdr_bytes) != hdr_crc:
            raise MPIError(
                f"checkpoint header CRC mismatch in {path!r} — torn or "
                f"corrupted write", code=_ec.ERR_FILE)
        try:
            header = pickle.loads(hdr_bytes)
            ranks_meta = header["ranks"]
            if rank < len(ranks_meta):
                _ = (ranks_meta[rank]["spec"], ranks_meta[rank]["offset"],
                     ranks_meta[rank]["leaves"])
        except Exception as e:
            raise MPIError(
                f"undecodable checkpoint header in {path!r}: "
                f"{type(e).__name__}: {e}", code=_ec.ERR_FILE) from None
        if shard is None and len(ranks_meta) != size:
            raise MPIError(
                f"checkpoint has {len(ranks_meta)} shards, comm has "
                f"{size} ranks (elastic resharding is not supported; pass "
                f"shard= to read a specific one)", code=_ec.ERR_SIZE)
        want = rank if shard is None else int(shard)
        if not (0 <= want < len(ranks_meta)):
            raise MPIError(
                f"checkpoint has {len(ranks_meta)} shards; shard {want} "
                f"does not exist", code=_ec.ERR_ARG)
        entry = ranks_meta[want]
        off = entry["offset"]
        leaves: dict[str, np.ndarray] = {}
        for k, dt, shape, nbytes, crc in entry["leaves"]:
            if off + nbytes > fsize:
                raise MPIError(
                    f"checkpoint shard for rank {rank} is truncated: leaf "
                    f"{k!r} needs bytes [{off}, {off + nbytes}) but "
                    f"{path!r} is {fsize} bytes", code=_ec.ERR_FILE)
            buf = np.empty(nbytes, np.uint8)
            File.read_at(fh, off, buf)      # independent: counts differ
            if zlib.crc32(buf) != crc:
                raise MPIError(
                    f"checkpoint payload CRC mismatch for leaf {k!r} "
                    f"(rank {rank}) in {path!r} — torn or corrupted write",
                    code=_ec.ERR_FILE)
            leaves[k] = buf.view(np.dtype(dt)).reshape(shape)
            off += nbytes
    finally:
        File.close(fh)
    Barrier(comm)
    return _unflatten(entry["spec"], leaves)


def load_all_shards(path: str, comm: Comm) -> list:
    """Resharding helper: read EVERY rank shard of a ``save_sharded``
    file, in writer-rank order, regardless of the reader comm's size.

    The restore half of elastic resharding: a world that shrank, grew, or
    replaced ranks since the checkpoint was written reassembles the
    writers' global state from all N shards and re-partitions it for its
    own size. Each caller reads the whole file; callers that only need a
    slice should use ``load_sharded(..., shard=s)`` directly."""
    return [load_sharded(path, comm, shard=s)
            for s in range(shard_count(path, comm))]
