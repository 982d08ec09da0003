"""Parallel file I/O: shared-file explicit-offset reads/writes with views —
the port of ``tpu_mpi/io.py``.

Reference: /root/reference/src/io.jl — FileHandle (:1-3), File.open with
Julia-style kwargs→amode flags (:12-62), close (:64-72), set_view!
(disp+etype+filetype+datarep, :87-98), sync (:111-115), read_at! (:131-140),
read_at_all! collective (:155-165), write_at (:179-188), write_at_all
collective (:203-212).

POSIX pread/pwrite at rank-computed offsets into one shared file, with
rendezvous barriers bracketing the ``_all`` collective variants; datatype
file views become offset arithmetic — an element index maps through the
filetype's block pattern tiled from ``disp``. This is also the checkpoint
substrate (:mod:`tpu_mpi_torch.checkpoint`).

Tensors: the file holds raw element bytes, so a tensor moves through host
memory for exactly the bytes it moves. A source is staged for its first
``count`` elements only (a CUDA tensor: one device-to-host copy of that
range; a CPU tensor: no copy when contiguous). A destination is filled by
reads into one host buffer and one ``copy_``: a raw tensor in place (a
partial read needs it contiguous, as for ``buffers.write_flat``), a
``DeviceBuffer`` by rebinding its cell.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from .buffers import (Buffer, DeviceBuffer, extract_array, itemsize,
                      write_flat)
from .comm import Comm
from .datatypes import BYTE, Datatype, to_datatype
from . import error as _ec
from .error import MPIError
from .pointtopoint import Status


class FileHandle:
    """An open shared file plus this rank's view (src/io.jl:1-3).

    Each rank holds its own OS file descriptor on the shared path; the view
    (disp, etype, filetype) is per-rank state exactly as in MPI.
    """

    def __init__(self, comm: Comm, path: str, fd: int, deleteonclose: bool):
        self.comm = comm
        self.path = path
        self.fd: Optional[int] = fd
        self.deleteonclose = deleteonclose
        # Default view: displacement 0, etype = filetype = BYTE (byte offsets).
        self.disp = 0
        self.etype: Datatype = BYTE
        self.filetype: Datatype = BYTE
        self.datarep = "native"

    def _check(self) -> None:
        if self.fd is None:
            raise MPIError("file has been closed", code=_ec.ERR_FILE)

    def close(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None
            if self.deleteonclose and self.comm.rank() == 0:
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass

    def __enter__(self) -> "FileHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self.fd is None else "open"
        return f"<FileHandle {self.path!r} ({state})>"


def _barrier(comm: Comm, opname: str) -> None:
    comm.channel().run(comm.rank(), None, lambda cs: [None] * len(cs),
                       f"{opname}@{comm.cid}")


def open(comm: Comm, filename: str, *, read: Optional[bool] = None,
         write: Optional[bool] = None, create: Optional[bool] = None,
         append: Optional[bool] = None, sequential: bool = False,
         uniqueopen: bool = False, deleteonclose: bool = False,
         **infokws) -> FileHandle:
    """Collectively open ``filename`` (src/io.jl:40-62). Keywords mirror the
    reference's Base.open-style flags; extra kwargs are Info hints."""
    do_read = bool(read) if read is not None else not bool(write)
    do_write = bool(write) if write is not None else False
    do_create = bool(create) if create is not None else do_write
    do_append = bool(append) if append is not None else False

    flags = 0
    if do_read and do_write:
        flags |= os.O_RDWR
    elif do_write:
        flags |= os.O_WRONLY
    else:
        flags |= os.O_RDONLY
    if do_write and do_create:
        flags |= os.O_CREAT
    if do_append:
        flags |= os.O_APPEND

    # Collective: rank 0 creates first so O_CREAT races cannot produce
    # different inodes on network filesystems; then everyone opens.
    if comm.rank() == 0:
        fd = os.open(filename, flags, 0o644)
        _barrier(comm, "File.open")
    else:
        _barrier(comm, "File.open")
        fd = os.open(filename, flags, 0o644)
    return FileHandle(comm, filename, fd, deleteonclose)


def close(file: FileHandle) -> None:
    """Close the handle (src/io.jl:64-72)."""
    file.close()


def set_view(file: FileHandle, disp: int, etype: Any, filetype: Any,
             datarep: str = "native", **infokws) -> FileHandle:
    """Set this rank's file view (src/io.jl:87-98): data starts at byte
    ``disp``; offsets in read/write calls count ``etype`` elements; the
    ``filetype`` pattern tiles the file from disp."""
    file._check()
    file.disp = int(disp)
    file.etype = to_datatype(etype)
    file.filetype = to_datatype(filetype) if filetype is not None else file.etype
    file.datarep = datarep
    return file


# Julia-parity alias (set_view! in the reference).
set_view_ = set_view


def sync(file: FileHandle) -> None:
    """Flush writes to storage, collectively (src/io.jl:111-115)."""
    file._check()
    os.fsync(file.fd)
    _barrier(file.comm, "File.sync")


def _view_byte_ranges(file: FileHandle, offset_etype: int, nbytes: int):
    """Map a span of ``nbytes`` payload bytes starting at element offset
    ``offset_etype`` (in etype units) through the view to (file_byte, length)
    runs. Contiguous filetype ⇒ one run; holes in the filetype tile the
    pattern across extents."""
    et = file.etype
    ft = file.filetype
    esz = et.extent_bytes
    # Payload byte ranges inside one filetype extent, in pattern order.
    runs = [(off, dt.itemsize * c) for (off, dt, c) in ft.blocks]
    bytes_per_tile = sum(n for _, n in runs)
    if bytes_per_tile == ft.extent_bytes and len(runs) <= 1:
        # Dense view: plain offset arithmetic.
        start = file.disp + offset_etype * esz
        return [(start, nbytes)]
    out = []
    want_start = offset_etype * esz          # payload byte position
    want_end = want_start + nbytes
    tile = want_start // bytes_per_tile
    payload_pos = tile * bytes_per_tile
    while payload_pos < want_end:
        for (off, length) in runs:
            seg_start = payload_pos
            seg_end = payload_pos + length
            lo = max(seg_start, want_start)
            hi = min(seg_end, want_end)
            if lo < hi:
                file_byte = file.disp + tile * ft.extent_bytes + off + (lo - seg_start)
                out.append((file_byte, hi - lo))
            payload_pos = seg_end
        tile += 1
    return out


def _pread_into(fd: int, mv: memoryview, pos: int) -> None:
    """Fill ``mv`` from file byte ``pos``; bytes past EOF read as zeros."""
    done = 0
    while done < len(mv):
        got = os.preadv(fd, [mv[done:]], pos + done)
        if got == 0:
            mv[done:] = bytes(len(mv) - done)      # short read past EOF
            return
        done += got


def _pwrite_from(fd: int, mv: memoryview, pos: int) -> None:
    done = 0
    while done < len(mv):
        done += os.pwrite(fd, mv[done:], pos + done)


def _host_bytes(data: Any, count: int) -> np.ndarray:
    """The first ``count`` elements of a send operand as flat host bytes
    (uint8), staged to host for exactly those elements."""
    arr = extract_array(data)
    if isinstance(arr, torch.Tensor):
        flat = arr.detach().reshape(-1)[:count]
        if flat.device.type != "cpu":
            flat = flat.cpu()
        return flat.contiguous().view(torch.uint8).numpy()
    flat = np.ravel(arr)[:count]
    return np.ascontiguousarray(flat).reshape(-1).view(np.uint8)


def _read_into(file: FileHandle, offset: int, data: Any) -> Status:
    file._check()
    buf = data if isinstance(data, Buffer) else Buffer(data)
    count = buf.count
    arr = extract_array(buf.data)
    # Payload length matches what _write_from emits: the raw element bytes
    # (itemsize includes struct padding; Datatype.size_bytes does not).
    nbytes = count * itemsize(arr)
    host = np.empty(nbytes, np.uint8)
    mv = memoryview(host)
    pos_in = 0
    for (pos, length) in _view_byte_ranges(file, int(offset), nbytes):
        _pread_into(file.fd, mv[pos_in:pos_in + length], pos)
        pos_in += length
    if isinstance(arr, torch.Tensor):
        vals = torch.from_numpy(host).view(arr.dtype)
        if isinstance(buf.data, torch.Tensor) and buf.data.is_contiguous():
            buf.data.view(-1)[:count].copy_(vals)   # one copy, in place
        else:
            if count == arr.numel():
                vals = vals.view(arr.shape)         # a cell rebinds to it
            write_flat(buf.data, vals.to(arr.device), count)
    else:
        write_flat(buf.data, host.view(arr.dtype), count)
    return Status(source=0, tag=0, count=count)


def _write_from(file: FileHandle, offset: int, data: Any) -> Status:
    file._check()
    buf = data if isinstance(data, Buffer) else Buffer(data)
    count = buf.count
    raw = _host_bytes(buf.data, count)
    mv = memoryview(raw)
    pos_in = 0
    for (pos, length) in _view_byte_ranges(file, int(offset), raw.nbytes):
        _pwrite_from(file.fd, mv[pos_in:pos_in + length], pos)
        pos_in += length
    return Status(source=0, tag=0, count=count)


def read_at(file: FileHandle, offset: int, data: Any) -> Status:
    """Noncollective read at explicit offset (src/io.jl:131-140).
    ``offset`` is in etype units of the current view."""
    return _read_into(file, offset, data)


def read_at_all(file: FileHandle, offset: int, data: Any) -> Status:
    """Collective read_at (src/io.jl:155-165): all ranks must call; barriers
    bracket the read so it observes every write issued before the collective."""
    _barrier(file.comm, "File.read_at_all:pre")
    st = _read_into(file, offset, data)
    _barrier(file.comm, "File.read_at_all:post")
    return st


def write_at(file: FileHandle, offset: int, data: Any) -> Status:
    """Noncollective write at explicit offset (src/io.jl:179-188)."""
    return _write_from(file, offset, data)


def write_at_all(file: FileHandle, offset: int, data: Any) -> Status:
    """Collective write_at (src/io.jl:203-212)."""
    _barrier(file.comm, "File.write_at_all:pre")
    st = _write_from(file, offset, data)
    _barrier(file.comm, "File.write_at_all:post")
    return st


def get_size(file: FileHandle) -> int:
    """File size in bytes (MPI_File_get_size)."""
    file._check()
    return os.fstat(file.fd).st_size


def set_size(file: FileHandle, size: int) -> None:
    """Collectively truncate/extend (MPI_File_set_size)."""
    file._check()
    os.ftruncate(file.fd, int(size))
    _barrier(file.comm, "File.set_size")


def delete(filename: str) -> None:
    """Delete a file (MPI_File_delete)."""
    try:
        os.unlink(filename)
    except FileNotFoundError:
        pass
