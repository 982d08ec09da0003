"""tpu_mpi_torch's MPI-IO and sharded checkpoints against tpu_mpi's.

Every case of tests/test_io.py is one SPMD program, written once against a
package ``M`` and an array factory ``AT``, run through both packages as in
tests/test_torch_p2p.py over the ``numpy``, ``devicebuffer`` and ``tensor``
kinds on seeded inputs; each run asserts the reference test's own checks,
and the port's per-rank results are held to the JAX package's bitwise.

Beyond them: for the same tree (a bfloat16 leaf, a structured dtype,
'/'-bearing keys, a 0-d leaf) the two packages write byte-identical
checkpoint files, and each loads the other's; tensors on the CPU stage to
host for exactly the elements they move; a torn or foreign file fails
loudly in both packages alike.
"""

import os
import tempfile

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_mpi as JMPI
import tpu_mpi_torch as MPI
from tpu_mpi import checkpoint as jckpt
from tpu_mpi_torch import checkpoint as tckpt

from test_torch_p2p import KINDS, TIMEOUT, assert_parity, host

SEED = 7


def _tmpname(M, comm):
    rank = M.Comm_rank(comm)
    name = tempfile.mktemp(prefix="tpu_mpi_torch_io_") if rank == 0 else None
    return M.bcast(name, 0, comm)


def _cleanup(M, comm, fh, filename):
    fh.close()
    M.Barrier(comm)
    if M.Comm_rank(comm) == 0:
        os.unlink(filename)


# ---------------------------------------------------------------------------
# tests/test_io.py
# ---------------------------------------------------------------------------

def p_io_interleaved(M, AT):
    """The reference's exact scenario (test_io.jl:21-45)."""
    def body():
        comm = M.COMM_WORLD
        rank, sz = M.Comm_rank(comm), M.Comm_size(comm)
        filename = _tmpname(M, comm)
        M.Barrier(comm)
        fh = M.File.open(comm, filename, read=True, write=True, create=True)
        try:
            M.File.set_view(fh, 0, M.INT64, M.INT64)
            M.File.write_at_all(fh, rank * 2, AT.full((2,), rank + 1, dtype=np.int64))
            M.File.sync(fh)
            every = None
            if rank == 0:
                data = AT.zeros(2 * sz, dtype=np.int64)
                M.File.read_at(fh, 0, data)
                assert M.testing.aeq(data, np.repeat(np.arange(1, sz + 1), 2))
                every = host(data)
            M.File.sync(fh)
            M.Barrier(comm)
            if rank == sz - 1:
                M.File.write_at(fh, 0, AT.full((2,), -1, dtype=np.int64))
            M.File.sync(fh)
            data = AT.zeros(1, dtype=np.int64)
            M.File.read_at_all(fh, rank * 2, data)
            assert host(data)[0] == (-1 if rank == 0 else rank + 1)
            return every, host(data)
        finally:
            _cleanup(M, comm, fh, filename)
    return body


def p_io_byte_default_view(M, AT):
    """Without set_view, offsets are byte offsets (etype = BYTE)."""
    def body():
        comm = M.COMM_WORLD
        rank, sz = M.Comm_rank(comm), M.Comm_size(comm)
        filename = _tmpname(M, comm)
        fh = M.File.open(comm, filename, read=True, write=True, create=True)
        try:
            M.File.write_at_all(fh, rank * 4, AT.full(4, rank, dtype=np.uint8))
            M.File.sync(fh)
            everything = AT.zeros(4 * sz, dtype=np.uint8)
            M.File.read_at_all(fh, 0, everything)
            assert M.testing.aeq(everything, np.repeat(np.arange(sz, dtype=np.uint8), 4))
            assert M.File.get_size(fh) == 4 * sz
            return host(everything)
        finally:
            _cleanup(M, comm, fh, filename)
    return body


def p_io_strided_filetype(M, AT):
    """A vector filetype interleaves ranks' elements (file views are
    offset arithmetic)."""
    def body():
        comm = M.COMM_WORLD
        rank, sz = M.Comm_rank(comm), M.Comm_size(comm)
        filename = _tmpname(M, comm)
        fh = M.File.open(comm, filename, read=True, write=True, create=True)
        try:
            ft = M.Types.create_vector(1, 1, sz, M.INT64)
            ft = M.Types.create_resized(ft, 0, sz * 8)
            M.File.set_view(fh, rank * 8, M.INT64, ft)
            mine = AT.full(3, rank, dtype=np.int64)   # 3 tiles
            M.File.write_at_all(fh, 0, mine)
            M.File.sync(fh)
            M.Barrier(comm)
            raw = np.fromfile(filename, dtype=np.int64)
            assert M.testing.aeq(raw, np.tile(np.arange(sz), 3))
            back = AT.zeros(3, dtype=np.int64)
            M.File.read_at_all(fh, 0, back)
            assert M.testing.aeq(back, mine)
            return raw, host(back)
        finally:
            _cleanup(M, comm, fh, filename)
    return body


def p_io_checkpoint_roundtrip(M, AT):
    """Checkpoint/restore a sharded state through the File layer."""
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        filename = _tmpname(M, comm)
        shard = AT.array(np.random.default_rng(SEED + rank)
                         .standard_normal(16).astype(np.float32))
        fh = M.File.open(comm, filename, write=True, create=True)
        try:
            M.File.set_view(fh, 0, M.FLOAT32, M.FLOAT32)
            M.File.write_at_all(fh, rank * 16, shard)
            M.File.sync(fh)
        finally:
            fh.close()
        M.Barrier(comm)
        fh = M.File.open(comm, filename, read=True)
        try:
            M.File.set_view(fh, 0, M.FLOAT32, M.FLOAT32)
            restored = AT.zeros(16, dtype=np.float32)
            M.File.read_at_all(fh, rank * 16, restored)
            assert M.testing.aeq(restored, shard)
            return host(restored)
        finally:
            _cleanup(M, comm, fh, filename)
    return body


def _tree(M, AT, rank):
    rng = np.random.default_rng(SEED + rank)
    return {
        "w": AT.array(rng.standard_normal((4, 8))),
        "step": np.array([100 + rank]),
        "layers": [AT.array(rng.standard_normal(3 + rank).astype(np.float32))
                   for _ in range(1 + rank % 2)],
        "meta": (np.arange(rank + 1),),
    }


def p_sharded_checkpoint_roundtrip(M, AT):
    """Heterogeneous per-rank trees round-trip through one coherent file."""
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        path = _tmpname(M, comm)
        tree = _tree(M, AT, rank)
        M.checkpoint.save_sharded(path, tree, comm)
        got = M.checkpoint.load_sharded(path, comm)
        assert isinstance(got["w"], np.ndarray)
        assert np.array_equal(got["w"], host(tree["w"]))
        assert got["step"][0] == 100 + rank
        assert len(got["layers"]) == len(tree["layers"])
        for a, b in zip(got["layers"], tree["layers"]):
            assert np.array_equal(a, host(b)) and a.dtype == host(b).dtype
        assert isinstance(got["meta"], tuple)
        assert np.array_equal(got["meta"][0], np.arange(rank + 1))
        M.Barrier(comm)
        if rank == 0:
            with open(path, "rb") as f:
                raw = f.read()
            os.remove(path)
            return got, raw
        return got
    return body


def p_sharded_checkpoint_edge_dtypes(M, AT):
    """'/'-bearing keys do not collide with nesting; structured dtypes keep
    their fields; object dtypes refuse BEFORE any collective."""
    def body():
        comm = M.COMM_WORLD
        rank = M.Comm_rank(comm)
        path = _tmpname(M, comm)
        structured = np.zeros(3, dtype=[("lr", "<f4"), ("step", "<i4")])
        structured["lr"] = rank + 0.5
        tree = {"a": {"b": AT.array(np.ones(4) * rank)},
                "a/b": AT.zeros(4),
                "opt": structured}
        M.checkpoint.save_sharded(path, tree, comm)
        got = M.checkpoint.load_sharded(path, comm)
        assert np.array_equal(got["a"]["b"], np.ones(4) * rank)
        assert np.array_equal(got["a/b"], np.zeros(4))
        assert got["opt"].dtype.names == ("lr", "step")
        assert np.allclose(got["opt"]["lr"], rank + 0.5)
        try:
            M.checkpoint.save_sharded(path + ".x",
                                      {"bad": np.array([1, "a"], object)}, comm)
            raise AssertionError("object dtype was stored")
        except M.MPIError as e:
            code = e.code
        M.Barrier(comm)
        if rank == 0:
            os.remove(path)
        return got, code
    return body


AT_CASES = [p_io_interleaved, p_io_byte_default_view, p_io_strided_filetype,
            p_io_checkpoint_roundtrip, p_sharded_checkpoint_roundtrip,
            p_sharded_checkpoint_edge_dtypes]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("program", AT_CASES, ids=lambda p: p.__name__[2:])
def test_parity(program, kind, nprocs):
    assert_parity(program, kind, nprocs)


def test_sharded_checkpoint_size_mismatch_parity(nprocs):
    """Loading with a different world size fails loudly with ERR_SIZE, in
    both packages."""
    codes = []
    for M in (JMPI, MPI):
        path = tempfile.mktemp(prefix="tpu_mpi_torch_ckpt_sz_")
        M.testing.run_spmd(
            lambda: M.checkpoint.save_sharded(path, {"x": np.ones(4)},
                                              M.COMM_WORLD), nprocs,
            timeout=TIMEOUT)

        def load():
            try:
                M.checkpoint.load_sharded(path, M.COMM_WORLD)
            except M.MPIError as e:
                return e.code

        codes.append(M.testing.run_spmd(load, 1, timeout=TIMEOUT))
        os.remove(path)
    assert codes[0] == codes[1] == [MPI.error.ERR_SIZE]


# ---------------------------------------------------------------------------
# One file format for both packages
# ---------------------------------------------------------------------------

def _format_tree(rank, bf16):
    """A tree with every leaf kind the format has to carry. ``bf16`` turns
    raw bfloat16 bits into the package's bfloat16 leaf."""
    rng = np.random.default_rng(SEED + 10 * rank)
    structured = np.zeros(2, dtype=[("lr", "<f4"), ("step", "<i4")])
    structured["step"] = rank
    bits = rng.integers(0, 1 << 16, 6, dtype=np.uint16)
    return {"params": {"w": rng.standard_normal((3, 5)),
                       "b/ias": rng.standard_normal(5).astype(np.float32)},
            "bf": bf16(bits), "opt": structured,
            "step": np.int64(7 + rank), "ints": [np.arange(rank + 2, dtype=np.int32)]}


def _jax_bf16(bits):
    return bits.view(ml_dtypes.bfloat16)


def _torch_bf16(bits):
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def _save(M, path, bf16, nprocs):
    M.testing.run_spmd(
        lambda: M.checkpoint.save_sharded(
            path, _format_tree(M.Comm_rank(M.COMM_WORLD), bf16), M.COMM_WORLD),
        nprocs, timeout=TIMEOUT)


def _load(M, path, nprocs):
    return M.testing.run_spmd(
        lambda: M.checkpoint.load_sharded(path, M.COMM_WORLD), nprocs,
        timeout=TIMEOUT)


def _leaf_bytes(tree):
    """Every leaf as (dtype string, shape, raw bytes), by key."""
    return {k: (a.dtype.str if a.dtype.names is None else a.dtype.descr,
                a.shape, a.tobytes())
            for k, a, _ in tckpt._flatten(tree)}


def test_checkpoint_files_are_byte_identical_and_cross_load(tmp_path, nprocs):
    jpath, tpath = str(tmp_path / "jax.ckpt"), str(tmp_path / "torch.ckpt")
    _save(JMPI, jpath, _jax_bf16, nprocs)
    _save(MPI, tpath, _torch_bf16, nprocs)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    for reader in (JMPI, MPI):
        got_j, got_t = _load(reader, jpath, nprocs), _load(reader, tpath, nprocs)
        for r in range(nprocs):
            # the bfloat16 leaf reads back as the JAX package records it:
            # its raw bits as 2-byte void records
            want = _leaf_bytes(_format_tree(r, lambda bits: bits.view("V2")))
            assert _leaf_bytes(got_j[r]) == _leaf_bytes(got_t[r]) == want
            assert isinstance(got_t[r]["ints"], list)


def test_checkpoint_header_holds_only_builtins(tmp_path):
    """Tensor leaves record a tuple shape and a numpy dtype string, so the
    JAX package unpickles the header without torch."""
    path = str(tmp_path / "t.ckpt")

    def body():
        MPI.checkpoint.save_sharded(
            path, {"t": torch.zeros(2, 3, dtype=torch.float64),
                   "d": MPI.DeviceBuffer(np.ones(4, np.int16), device="cpu"),
                   "bf": torch.ones(3, dtype=torch.bfloat16)}, MPI.COMM_WORLD)

    MPI.testing.run_spmd(body, 2, timeout=TIMEOUT)
    code = ("import pickle, sys\n"
            "sys.modules['torch'] = None\n"
            f"raw = open({path!r}, 'rb').read()\n"
            "n = int.from_bytes(raw[16:24], 'little')\n"
            "h = pickle.loads(raw[32:32 + n])\n"
            "print(h['ranks'][1]['leaves'])\n")
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    leaves = eval(out.stdout)
    assert [(k, dt, shape) for k, dt, shape, _, _ in leaves] == [
        ("bf", "<V2", (3,)), ("d", "<i2", (4,)), ("t", "<f8", (2, 3))]


@pytest.mark.parametrize("damage", ["truncated", "payload", "header", "v1",
                                    "foreign"])
def test_damaged_checkpoint_fails_alike(tmp_path, damage):
    """A torn, corrupted, old or foreign file fails with the same MPIError
    code in both packages, before any data is returned."""
    path = str(tmp_path / "c.ckpt")
    _save(MPI, path, _torch_bf16, 2)
    raw = bytearray(open(path, "rb").read())
    if damage == "truncated":
        raw = raw[:len(raw) - 3]
    elif damage == "payload":
        raw[-1] ^= 0xFF
    elif damage == "header":
        raw[40] ^= 0xFF
    elif damage == "v1":
        raw[:8] = (0x7D5AC4B7_00000001).to_bytes(8, "little")
    else:
        raw[:8] = bytes(8)
    open(path, "wb").write(bytes(raw))

    def codes(M):
        # one reader of the damaged last shard: a rank that failed alone
        # would leave its peers waiting at the closing Barrier
        def load():
            try:
                M.checkpoint.load_sharded(path, M.COMM_WORLD, shard=1)
            except M.MPIError as e:
                return e.code, type(e).__name__
        return M.testing.run_spmd(load, 1, timeout=TIMEOUT)

    got = codes(MPI)
    assert got == codes(JMPI)
    assert got[0] == (MPI.error.ERR_FILE, "MPIError")


def test_shard_count_parity(tmp_path, nprocs):
    path = str(tmp_path / "n.ckpt")
    _save(JMPI, path, _jax_bf16, nprocs)
    for M, ck in ((JMPI, jckpt), (MPI, tckpt)):
        got = M.testing.run_spmd(lambda: ck.shard_count(path, M.COMM_WORLD), 2,
                                 timeout=TIMEOUT)
        assert got == [nprocs, nprocs]


# ---------------------------------------------------------------------------
# Tensors in the File layer
# ---------------------------------------------------------------------------

def test_read_into_raw_tensor_in_place_and_partial(tmp_path):
    """A raw tensor is read into in place (its storage kept), a partial
    read fills only ``count`` elements, and a DeviceBuffer rebinds."""
    path = str(tmp_path / "r.bin")
    vals = np.random.default_rng(SEED).standard_normal(8).astype(np.float32)
    vals.tofile(path)

    def body():
        comm = MPI.COMM_WORLD
        fh = MPI.File.open(comm, path, read=True)
        try:
            t = torch.full((2, 4), -1.0)
            ptr = t.data_ptr()
            MPI.File.read_at(fh, 0, t)
            assert t.data_ptr() == ptr and np.array_equal(t.numpy().ravel(), vals)
            part = torch.full((6,), -1.0)
            MPI.File.read_at(fh, 0, MPI.Buffer(part, 3))
            assert part.tolist()[3:] == [-1.0] * 3
            assert np.array_equal(part[:3].numpy(), vals[:3])
            cell = MPI.DeviceBuffer(np.zeros((2, 4), np.float32), device="cpu")
            MPI.File.read_at(fh, 0, cell)
            assert cell.shape == (2, 4)
            assert np.array_equal(cell.value.numpy().ravel(), vals)
        finally:
            fh.close()

    MPI.testing.run_spmd(body, 1, timeout=TIMEOUT)


def test_write_stages_only_count_elements(monkeypatch, tmp_path):
    """A write of ``count`` elements of a larger tensor moves exactly those
    bytes; a bfloat16 tensor writes its raw bits."""
    path = str(tmp_path / "w.bin")
    big = torch.arange(1000, dtype=torch.float64)
    bf = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    seen = []
    real = os.pwrite

    def spy(fd, data, pos):
        seen.append(len(data))
        return real(fd, data, pos)

    monkeypatch.setattr(os, "pwrite", spy)

    def body():
        fh = MPI.File.open(MPI.COMM_WORLD, path, write=True, create=True)
        try:
            MPI.File.write_at(fh, 0, MPI.Buffer(big, 5))
            MPI.File.write_at(fh, 40, bf)
        finally:
            fh.close()

    MPI.testing.run_spmd(body, 1, timeout=TIMEOUT)
    assert seen == [40, 6]
    raw = open(path, "rb").read()
    assert np.frombuffer(raw[:40], np.float64).tolist() == [0, 1, 2, 3, 4]
    assert raw[40:] == bf.view(torch.int16).numpy().tobytes()


def test_file_handle_closed_and_delete():
    path = tempfile.mktemp(prefix="tpu_mpi_torch_io_")

    def body():
        fh = MPI.File.open(MPI.COMM_WORLD, path, write=True, create=True)
        MPI.File.set_size(fh, 64)
        assert MPI.File.get_size(fh) == 64
        MPI.File.close(fh)
        try:
            MPI.File.get_size(fh)
        except MPI.MPIError as e:
            return e.code

    assert MPI.testing.run_spmd(body, 1, timeout=TIMEOUT) == [MPI.error.ERR_FILE]
    MPI.File.delete(path)
    MPI.File.delete(path)           # a missing file is no error
    assert not os.path.exists(path)

