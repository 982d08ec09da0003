"""tpu_mpi_torch's runtime, environment and object model: the port's
counterparts of tests/test_basic.py and tests/test_comm.py, the import
rules (no jax, nothing of tpu_mpi), the device rule, and the operands
carried across between numpy and torch."""

import ast
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_mpi_torch as MPI
from tpu_mpi_torch import buffers, datatypes, implementations
from tpu_mpi_torch.testing import NumpyFactory, TensorFactory, aeq, run_spmd

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 60


# ---------------------------------------------------------------------------
# Lifecycle and communicators (tests/test_basic.py, tests/test_comm.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nprocs", [2, 4])
def test_init_finalize_rank_size(nprocs):
    def body():
        assert MPI.Initialized() and not MPI.Finalized()
        comm = MPI.COMM_WORLD
        t0 = MPI.Wtime()
        rank, size = MPI.Comm_rank(comm), MPI.Comm_size(comm)
        assert size == nprocs and 0 <= rank < size
        assert MPI.Wtime() >= t0
        MPI.Finalize()
        assert MPI.Finalized()
        return rank

    assert sorted(run_spmd(body, nprocs, timeout=TIMEOUT)) == list(range(nprocs))


def test_double_init_raises():
    def body():
        with pytest.raises(MPI.MPIError):
            MPI.Init()

    run_spmd(body, 2, timeout=TIMEOUT)


def test_singleton_init_world_of_one():
    result = {}

    def standalone():
        MPI.Init()
        result["size"] = MPI.Comm_size(MPI.COMM_WORLD)
        result["rank"] = MPI.Comm_rank(MPI.COMM_WORLD)
        MPI.Finalize()

    t = threading.Thread(target=standalone)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert result == {"size": 1, "rank": 0}


def test_rank_error_fails_whole_run():
    def body():
        if MPI.Comm_rank(MPI.COMM_WORLD) == 1:
            raise ValueError("rank 1 exploded")
        MPI.Barrier(MPI.COMM_WORLD)       # released by the abort

    with pytest.raises((ValueError, MPI.AbortError)):
        run_spmd(body, 3, timeout=TIMEOUT)


def test_collective_mismatch_detected():
    def body():
        comm = MPI.COMM_WORLD
        if MPI.Comm_rank(comm) == 0:
            MPI.Barrier(comm)
        else:
            MPI.Allreduce(1, MPI.SUM, comm)

    with pytest.raises((MPI.CollectiveMismatchError, MPI.AbortError)):
        run_spmd(body, 3, timeout=TIMEOUT)


def test_collectives_isolated_across_comms():
    def body():
        comm = MPI.COMM_WORLD
        rank, size = MPI.Comm_rank(comm), MPI.Comm_size(comm)
        comm2 = MPI.Comm_dup(comm)
        a = MPI.Allreduce(rank, MPI.SUM, comm)
        b = MPI.Allreduce(1, MPI.SUM, comm2)
        assert a == size * (size - 1) // 2
        assert b == size

    run_spmd(body, 4, timeout=TIMEOUT)


def test_spmd_run_timeout_fails_fast():
    def body():
        if MPI.Comm_rank(MPI.COMM_WORLD) == 0:
            MPI.Barrier(MPI.COMM_WORLD)     # rank 1 never arrives

    with pytest.raises((MPI.DeadlockError, MPI.AbortError)):
        MPI.spmd_run(lambda: (MPI.Init(), body()), 2, timeout=2.0)


@pytest.mark.parametrize("factory", [NumpyFactory, TensorFactory("cpu")],
                         ids=["numpy", "tensor"])
def test_bcast_and_barrier(factory):
    def body():
        comm = MPI.COMM_WORLD
        rank = MPI.Comm_rank(comm)
        buf = factory.full(5, float(rank), dtype=np.float64)
        MPI.Bcast(buf, 2, comm)
        MPI.Barrier(comm)
        assert aeq(buf, np.full(5, 2.0))
        if isinstance(buf, MPI.DeviceBuffer):
            assert buf.device.type == "cpu"

    run_spmd(body, 3, timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# Import rules
# ---------------------------------------------------------------------------

def _port_sources():
    pkg = REPO / "tpu_mpi_torch"
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax_and_no_tpu_mpi():
    bad = []
    for f in _port_sources():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "tpu_mpi"):
                    bad.append(f"{f.relative_to(REPO)}:{node.lineno} {name}")
    assert not bad, bad


def test_port_scan_covers_the_process_tier():
    """The import scan above reads the multi-process tier's modules too."""
    scanned = {f.relative_to(REPO).as_posix() for f in _port_sources()}
    for mod in ("backend.py", "launcher.py", "_spawn_child.py",
                "_rma_wire.py", "_native/__init__.py"):
        assert f"tpu_mpi_torch/{mod}" in scanned, mod
    native = (REPO / "tpu_mpi_torch" / "_native" / "transport.cc").read_text()
    assert "tpu_mpi/" not in native.replace("tpu_mpi_torch", "")


def test_port_scan_covers_the_serve_tier():
    """The import scan above reads the serve tier and stats too."""
    scanned = {f.relative_to(REPO).as_posix() for f in _port_sources()}
    for mod in ("stats.py", "serve/__init__.py", "serve/protocol.py",
                "serve/queueing.py", "serve/ledger.py", "serve/session.py",
                "serve/broker.py", "serve/worker.py", "serve/frontdoor.py",
                "serve/router.py"):
        assert f"tpu_mpi_torch/{mod}" in scanned, mod


def test_port_scan_covers_infer_and_elastic():
    """The import scan above reads the inference engine and the elastic
    tier too."""
    scanned = {f.relative_to(REPO).as_posix() for f in _port_sources()}
    for mod in ("infer/__init__.py", "infer/engine.py", "infer/kvcache.py",
                "infer/scheduler.py", "elastic/__init__.py",
                "elastic/controller.py", "elastic/protocol.py",
                "elastic/sidecar.py"):
        assert f"tpu_mpi_torch/{mod}" in scanned, mod


def test_infer_and_elastic_run_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "from tpu_mpi_torch import serve\n"
        "import tpu_mpi_torch.infer, tpu_mpi_torch.elastic.sidecar\n"
        "b = serve.Broker(nranks=2, token='t', device='cpu', infer=True,\n"
        "                 elastic=True)\n"
        "b.run_in_thread()\n"
        "with serve.attach(b.address, token='t') as s:\n"
        "    out = s.generate([1, 2, 3], max_new=3)\n"
        "b.close()\n"
        "assert len(out) == 3, out\n"
        "leaked = [m for m in sys.modules if m == 'tpu_mpi'"
        " or m.startswith('tpu_mpi.')]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_serve_tier_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import numpy as np\n"
        "import tpu_mpi_torch as MPI\n"
        "import tpu_mpi_torch.stats\n"
        "from tpu_mpi_torch import serve\n"
        "import tpu_mpi_torch.serve.frontdoor, tpu_mpi_torch.serve.router\n"
        "import tpu_mpi_torch.serve.worker\n"
        "b = serve.Broker(nranks=2, token='t', device='cpu')\n"
        "b.run_in_thread()\n"
        "with serve.attach(b.address, token='t') as s:\n"
        "    out = s.allreduce(np.ones(3))\n"
        "b.close()\n"
        "assert out.tolist() == [2.0, 2.0, 2.0], out\n"
        "leaked = [m for m in sys.modules if m == 'tpu_mpi'"
        " or m.startswith('tpu_mpi.')]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _public_exports(init: Path) -> set:
    """The public names a package's ``__init__`` binds at top level: what
    it imports from its modules, assigns, and defines."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


# Names of tpu_mpi's namespace the port does not bind yet, with the ROADMAP
# Queue A item that brings each (or the port's counterpart).
WAITING = {
    "has_tpu": "no counterpart: has_cuda",
}


def test_top_level_namespace_matches_the_jax_package():
    """Read by AST, so no jax is imported here: the port binds every public
    name of tpu_mpi's namespace apart from the explicit waiting list."""
    want = _public_exports(REPO / "tpu_mpi" / "__init__.py")
    got = _public_exports(REPO / "tpu_mpi_torch" / "__init__.py")
    assert want - got == set(WAITING)
    assert got - want == {"has_cuda", "from_numpy", "to_numpy", "testing"}
    for name in want - set(WAITING):
        assert hasattr(MPI, name), name


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import tpu_mpi_torch as MPI\n"
        "import tpu_mpi_torch.collective, tpu_mpi_torch.tune\n"
        "import tpu_mpi_torch.tune_online, tpu_mpi_torch.analyze.matcher\n"
        "import tpu_mpi_torch.xla\n"
        "import tpu_mpi_torch.backend, tpu_mpi_torch.launcher\n"
        "import tpu_mpi_torch._native, tpu_mpi_torch._rma_wire\n"
        "import tpu_mpi_torch._spawn_child\n"
        "import tpu_mpi_torch.lint, tpu_mpi_torch.analyze.concurrency\n"
        "import tpu_mpi_torch.analyze.explore, tpu_mpi_torch.analyze.timeline\n"
        "import tpu_mpi_torch.analyze.__main__\n"
        "out = MPI.testing.run_spmd(lambda: MPI.Allreduce(1, MPI.SUM,"
        " MPI.COMM_WORLD), 2, timeout=30)\n"
        "assert out == [2, 2], out\n"
        "leaked = [m for m in sys.modules if m == 'tpu_mpi'"
        " or m.startswith('tpu_mpi.')]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# Device rule
# ---------------------------------------------------------------------------

def test_device_buffer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MPI.MPIError, match="CUDA"):
        MPI.DeviceBuffer(np.zeros(3))
    with pytest.raises(MPI.MPIError):
        MPI.from_numpy(np.zeros(3))
    cpu = MPI.DeviceBuffer(np.zeros(3), device="cpu")
    assert cpu.device.type == "cpu"


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_platform_probe_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = implementations.platform_probe()
    assert rep["backend"] == "CPU" and rep["device_count"] == 0
    assert rep["capabilities"]["spec_sheet"] is True
    assert "torch" in MPI.Get_library_version()
    assert not MPI.has_cuda() or os.environ.get("TPU_MPI_HAS_CUDA")


def test_profile_trace_writes_chrome_trace(tmp_path):
    with MPI.profile_trace(str(tmp_path)) as tr:
        (torch.arange(128.0) * 2).sum()
    files = list(tmp_path.glob("trace-rank0-*.json"))
    assert files and files[0].stat().st_size > 0
    assert tr.profile is not None


# ---------------------------------------------------------------------------
# Operands carried across, dtype mapping, copy on write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int8",
                                   "int16", "int32", "int64", "uint8", "bool"])
def test_numpy_roundtrip(dtype):
    arr = (np.arange(-5, 6) % 3).astype(dtype)
    t = MPI.from_numpy(arr, "cpu")
    assert t.dtype == datatypes.torch_dtype(np.dtype(dtype))
    back = MPI.to_numpy(t)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    arr[0] = 1                                   # from_numpy copied
    assert MPI.to_numpy(t)[0] == (np.arange(-5, 6) % 3).astype(dtype)[0]


def test_bfloat16_crosses_as_bits():
    bits = np.array([0x3F80, 0xC000, 0x7FC0, 0x0000], dtype=np.uint16)
    t = MPI.from_numpy(bits, "cpu", dtype=torch.bfloat16)
    assert t.dtype == torch.bfloat16
    assert t[:2].tolist() == [1.0, -2.0] and torch.isnan(t[2])
    np.testing.assert_array_equal(MPI.to_numpy(t), bits)
    assert datatypes.torch_dtype(datatypes.BFLOAT16) == torch.bfloat16
    assert datatypes.to_datatype(torch.bfloat16) is datatypes.BFLOAT16


def test_datatype_mapping():
    assert datatypes.to_datatype(torch.int32) is datatypes.INT32
    assert datatypes.torch_dtype(np.float16) == torch.float16
    assert datatypes.torch_dtype(datatypes.UINT64) == torch.uint64
    with pytest.raises(MPI.MPIError):
        datatypes.torch_dtype(np.dtype("U3"))


def test_cell_mutations_copy_on_write():
    shared = torch.arange(6.0)
    a = MPI.DeviceBuffer(shared, device="cpu")
    b = MPI.DeviceBuffer(shared, device="cpu")
    assert a.value is shared and b.value is shared       # zero-copy rebind
    a[0] = 100.0
    a.setflat(np.array([-1.0, -2.0]), 2)
    b.fill(3.0)
    assert shared.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert a.value.tolist() == [-1.0, -2.0, 2.0, 3.0, 4.0, 5.0]
    assert b.value.tolist() == [3.0] * 6
    b.setflat(shared)                                    # full rebind
    assert b.value is shared
    e = MPI.DeviceBuffer.empty((2, 3), np.int32, device="cpu")
    assert e.shape == (2, 3) and e.dtype == torch.int32
    assert e.device.type == "cpu" and len(e) == 2 and e.nbytes == 24


def test_raw_tensor_operands():
    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = torch.full((4,), float(r + 1))
        y = torch.zeros(4)
        MPI.Allreduce(x, y, MPI.SUM, comm)               # written in place
        return y.tolist(), buffers.to_wire(x) is not x

    res = run_spmd(body, 3, timeout=TIMEOUT)
    assert all(v == [6.0] * 4 and snap for v, snap in res)


def test_port_scan_covers_the_analysis_tier():
    """The import scan above reads the analysis modules and the lint CLI
    too, and none of them names the JAX package."""
    scanned = {f.relative_to(REPO).as_posix() for f in _port_sources()}
    for mod in ("lint.py", "analyze/__init__.py", "analyze/__main__.py",
                "analyze/lint.py", "analyze/concurrency.py",
                "analyze/explore.py", "analyze/timeline.py",
                "analyze/matcher.py", "analyze/events.py"):
        assert f"tpu_mpi_torch/{mod}" in scanned, mod
        text = (REPO / "tpu_mpi_torch" / mod).read_text()
        assert not re.search(r"\btpu_mpi\b(?!_torch)", text), mod
