"""The cross-rank trace verifier of the port (``matcher.verify_trace``).

``tests/test_analyze_trace.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name,
running the corpus rewritten for the port (``port_corpus``). Beside it:

- every corpus file traced through both packages gives the same
  diagnostics (code, line, message);
- the Isend check (T206) reads a tensor's bytes as they stand: a bfloat16
  tensor and one that requires grad get T206 at the line the JAX package
  reports for an ml_dtypes bfloat16 array;
- a trace names an element type as numpy does, whatever the operand, so
  a numpy float32 and a float32 tensor on two ranks agree (no T202), and
  a true mismatch of tensors reads as the JAX package's of numpy arrays;
- ``merge_trace`` across OS processes gives the JAX package's timeline.
"""

import json
import os
import re
import runpy

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_mpi
import tpu_mpi_torch

from test_torch_refport import CORPUS, adopt, corpus_subs, port_corpus, \
    port_module

_REF = port_module("test_analyze_trace", subs=corpus_subs())
adopt(globals(), _REF)

_FILES = sorted(f for f in os.listdir(CORPUS) if f.endswith(".py"))


@pytest.fixture
def both_traced(monkeypatch):
    monkeypatch.setenv("TPU_MPI_TRACE", "1")
    monkeypatch.setenv("TPU_MPI_DEADLOCK_TIMEOUT", "2.0")
    for pkg in (tpu_mpi, tpu_mpi_torch):
        pkg.config.load(refresh=True)
    yield
    os.environ.pop("TPU_MPI_AUTO_ARM_DONATE", None)
    monkeypatch.delenv("TPU_MPI_TRACE")
    for pkg in (tpu_mpi, tpu_mpi_torch):
        pkg.config.load(refresh=True)


def _finding(d):
    """A finding as plain values, in the terms both packages share
    whatever the threads' timing: a persistent plan's round ordinals count
    on across runs of a process (in both packages), so R302's ``round-N``
    is compared as a shape; R301 anchors at the later of its two racing
    accesses, so its two sites and its two accesses are compared as
    sets."""
    msg = re.sub(r"round-\d+", "round-N", d.message)
    if d.code != "R301":
        return d.code, os.path.basename(d.file), d.line, msg
    sites = sorted([(os.path.basename(d.file), d.line)]
                   + [(os.path.basename(f), ln) for f, ln, _ in d.related])
    m = re.fullmatch(r"(.*: )(.*) and (.*)( both touch .*)", msg)
    return d.code, tuple(sites), m.group(1) + " and ".join(
        sorted(m.group(2, 3))) + m.group(4)


def _run(pkg, body, nprocs):
    """``body`` on ``nprocs`` ranks of one package; the exception's type
    name (or None) and the verifier's findings (:func:`_finding`)."""
    err = None
    try:
        pkg.testing.run_spmd(body, nprocs=nprocs)
    except Exception as e:          # noqa: BLE001 — defects are expected
        err = type(e).__name__
    diags = pkg.analyze.verify_trace(pkg.analyze.last_trace())
    return err, sorted(_finding(d) for d in diags)


def _corpus_run(pkg, path):
    nprocs, _ = _REF.corpus_header(path)
    return _run(pkg, lambda: runpy.run_path(path, run_name="__main__"),
                nprocs)


@pytest.mark.parametrize("name", _FILES)
def test_verify_trace_equals_jax_on_corpus(both_traced, name):
    got = _corpus_run(tpu_mpi_torch, os.path.join(port_corpus(), name))
    want = _corpus_run(tpu_mpi, os.path.join(CORPUS, name))
    assert got == want


# -- T206 on tensors the JAX package's numpy route could not read ------------

def _isend_then(M, make, recv_buf, mutate):
    """Rank 0 Isends ``make()``, optionally writes it, then Waits."""
    def body():
        comm = M.COMM_WORLD
        if M.Comm_rank(comm) == 0:
            x = make()
            req = M.Isend(x, 1, 5, comm)
            if mutate:
                with torch.no_grad():
                    x[0] = 99
            M.Wait(req)
        else:
            M.Recv(recv_buf(), 0, 5, comm)
        M.Barrier(comm)
    return body


_ISEND_LINE = _isend_then.__code__.co_firstlineno + 6


def _bf16_np():
    return np.ones(8, ml_dtypes.bfloat16)


_PORT_BUFFERS = {
    "bfloat16": (lambda: torch.ones(8, dtype=torch.bfloat16),
                 lambda: torch.zeros(8, dtype=torch.bfloat16)),
    "requires_grad": (lambda: torch.ones(8, requires_grad=True),
                      lambda: torch.zeros(8)),
}
_UNTOUCHED = dict(_PORT_BUFFERS, device_buffer_bf16=(
    lambda: tpu_mpi_torch.DeviceBuffer(torch.ones(8, dtype=torch.bfloat16),
                                       device="cpu"),
    lambda: torch.zeros(8, dtype=torch.bfloat16)))


@pytest.mark.parametrize("kind", sorted(_PORT_BUFFERS))
def test_t206_on_tensors_as_jax_on_bfloat16(both_traced, kind):
    want = _run(tpu_mpi, _isend_then(tpu_mpi, _bf16_np, _bf16_np, True), 2)
    make, recv = _PORT_BUFFERS[kind]
    got = _run(tpu_mpi_torch, _isend_then(tpu_mpi_torch, make, recv, True), 2)
    codes = [(c, f, ln) for c, f, ln, _ in want[1]]
    assert codes == [("T206", os.path.basename(__file__), _ISEND_LINE)]
    assert got == want


@pytest.mark.parametrize("kind", sorted(_UNTOUCHED))
def test_untouched_isend_buffer_is_clean(both_traced, kind):
    make, recv = _UNTOUCHED[kind]
    assert _run(tpu_mpi_torch,
                _isend_then(tpu_mpi_torch, make, recv, False), 2) == (None, [])


def test_device_buffer_bf16_mutation_is_t206(both_traced):
    def body():
        M = tpu_mpi_torch
        comm = M.COMM_WORLD
        if M.Comm_rank(comm) == 0:
            x = M.DeviceBuffer(torch.ones(8, dtype=torch.bfloat16),
                               device="cpu")
            req = M.Isend(x, 1, 5, comm)
            x.value[0] = 99
            M.Wait(req)
        else:
            M.Recv(torch.zeros(8, dtype=torch.bfloat16), 0, 5, comm)
    _, diags = _run(tpu_mpi_torch, body, 2)
    assert [d[0] for d in diags] == ["T206"]


def test_buf_crc_reads_tensor_bytes_as_numpy():
    from tpu_mpi.analyze.events import _buf_crc as jcrc
    from tpu_mpi_torch.analyze.events import _buf_crc as pcrc
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    assert pcrc(torch.from_numpy(a)) == jcrc(a)
    assert pcrc(torch.from_numpy(a).t()) == jcrc(a.T)      # strided
    assert pcrc(torch.from_numpy(a).requires_grad_()) == jcrc(a)
    b = a.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(b.view(np.uint16).astype(np.int16)).view(
        torch.bfloat16)
    assert pcrc(t) == jcrc(b)
    assert pcrc(np.arange(4)) == jcrc(np.arange(4))


# -- the trace names element types as numpy does -----------------------------

def _mixed_kinds(M, kinds):
    """Each rank passes its own kind of one float32 array."""
    def body():
        comm = M.COMM_WORLD
        r = M.Comm_rank(comm)
        x = kinds[r](np.arange(6, dtype=np.float32))
        M.Allreduce(x, M.SUM, comm)
        M.Bcast(x, 0, comm)
        if r == 0:
            M.Send(x, 1, 1, comm)
        elif r == 1:
            M.Recv(x, 0, 1, comm)
    return body


def test_numpy_and_tensor_of_one_dtype_give_no_t202(both_traced):
    kinds = [lambda a: a, torch.from_numpy]
    assert _run(tpu_mpi_torch, _mixed_kinds(tpu_mpi_torch, kinds), 2) \
        == (None, [])
    tr = tpu_mpi_torch.analyze.last_trace()
    names = {ev.dtype for ev in tr.events() if ev.dtype is not None}
    assert names == {"float32", "<Datatype float32 size=4 extent=4>"}


def test_three_kinds_record_one_dtype(both_traced):
    kinds = [lambda a: a, torch.from_numpy,
             lambda a: tpu_mpi_torch.DeviceBuffer(a, device="cpu")]
    assert _run(tpu_mpi_torch, _mixed_kinds(tpu_mpi_torch, kinds), 3) \
        == (None, [])


def _dtype_mismatch(M, kind):
    """``defect_dtype_mismatch``'s program over one kind of operand."""
    def body():
        comm = M.COMM_WORLD
        if M.Comm_rank(comm) == 0:
            M.Bcast(kind(np.zeros(4, dtype=np.float32)), 0, comm)
        else:
            M.Bcast(kind(np.zeros(4, dtype=np.float64)), 0, comm)
    return body


@pytest.mark.parametrize("kind", ["tensor", "device_buffer"])
def test_tensor_dtype_mismatch_reads_as_jax_numpy(both_traced, kind):
    wrap = torch.from_numpy if kind == "tensor" else \
        (lambda a: tpu_mpi_torch.DeviceBuffer(a, device="cpu"))
    want = _run(tpu_mpi, _dtype_mismatch(tpu_mpi, lambda a: a), 2)
    got = _run(tpu_mpi_torch, _dtype_mismatch(tpu_mpi_torch, wrap), 2)
    assert [d[0] for d in want[1]] == ["T202"]
    assert "['float32', 'float64']" in want[1][0][3]
    assert got == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.bool])
def test_dtype_name_is_numpys(dtype):
    from tpu_mpi_torch.analyze.events import _datatype_name, dtype_name
    from tpu_mpi_torch.datatypes import to_datatype
    np_name = {torch.bfloat16: "bfloat16"}.get(dtype) or str(
        torch.empty(0, dtype=dtype).numpy().dtype)
    assert dtype_name(dtype) == dtype_name(str(dtype)) == np_name
    assert _datatype_name(to_datatype(dtype)) == \
        repr(tpu_mpi.datatypes.to_datatype(
            np.dtype(ml_dtypes.bfloat16) if np_name == "bfloat16"
            else np.dtype(np_name)))


# -- the merged timeline across OS processes ----------------------------------

_MERGE = """
import collections
import json
os.environ["TPU_MPI_TRACE"] = "1"
_config.load(refresh=True)
MPI.Init()
comm = MPI.COMM_WORLD
rank, size = MPI.Comm_rank(comm), MPI.Comm_size(comm)
kind = "tensor" if TORCH else "np"
for i in range(3):
    MPI.Allreduce(mk(np.arange(4096, dtype=np.float32) + rank + i, kind),
                  MPI.SUM, comm)
offs = MPI.analyze.clock_offsets(comm)
assert len(offs) == size and offs[0] == 0.0, offs
path = "OUT." + MPI.__name__ + ".json"
rec = MPI.analyze.merge_trace(comm, path)
assert (rec is None) == (rank != 0)
MPI.Finalize()
"""


def test_merge_trace_across_processes_as_jax(tmp_path):
    """``merge_trace`` on the process tier (each rank its own tracer and
    clock; ``clock_offsets`` Allgathers host float64 samples): the port's
    Chrome trace of tensor Allreduces has the JAX package's rows, slices
    and phases, every rank's timestamps in order."""
    from test_torch_coll_algos import launch_both
    out = str(tmp_path / "merged")
    runs = launch_both(str(tmp_path), _MERGE.replace("OUT", out))
    shapes = {}
    for pkg, res in runs.items():
        assert res.returncode == 0, (pkg, res.stderr[-4000:])
        with open(f"{out}.{pkg}.json") as f:
            rec = json.load(f)
        assert rec["otherData"]["schema"] == 2
        evs = rec["traceEvents"]
        slices = [e for e in evs if e["ph"] == "X"]
        for pid in range(4):
            ts = [e["ts"] for e in slices if e["pid"] == pid
                  and e["cat"] == "coll"]
            assert ts and ts == sorted(ts) and min(ts) >= 0
        shapes[pkg] = (
            sorted((e["pid"], e["args"]["name"]) for e in evs
                   if e["ph"] == "M" and e["name"] == "process_name"),
            sorted((e["pid"], e["name"]) for e in slices
                   if e["cat"] == "coll"),
            sorted({e["name"] for e in slices if e["cat"] == "phase"}))
    assert shapes["tpu_mpi_torch"] == shapes["tpu_mpi"]
    assert [n for _, n in shapes["tpu_mpi"][1]].count("Allreduce@0") == 12
