"""The port's launcher (``tpurun-torch``, ``python -m
tpu_mpi_torch.launcher``), held against the JAX package's
(``tests/test_error_launcher.py``): a raising rank fails the whole run,
a clean run exits 0, ``sys.exit`` codes propagate — on rank threads and on
rank processes alike — and ``install_tpurun`` writes a wrapper that
launches the port. ``--tune`` reaches the port's autotuner, ``--serve``
the port's broker (a client process attaches with ``MPI.Init(session=)``)
and ``--stats`` the port's pvar reporter. Rank processes share the card or
take a pool entry, ``--sim`` places them on the CPU, and two invocations
join one world.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from test_torch_coll_algos import PRELUDE, REPO, _env
from test_torch_procs import _launch


def _start(tmp_path, pkg, body, nprocs, procs):
    path = tmp_path / f"{pkg}_{'procs' if procs else 'threads'}.py"
    path.write_text(f"import sys; sys.path.insert(0, {REPO!r})\n"
                    + textwrap.dedent(body).replace("__PKG__", pkg))
    env = _env()
    mode = ["--procs", "--sim", "1"] if procs else ["--sim", str(nprocs)]
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.launcher", "-n", str(nprocs), *mode,
         "--timeout", "100", str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)


def _both(tmp_path, body, nprocs, procs):
    """The body under both launchers, side by side."""
    started = {pkg: _start(tmp_path, pkg, body, nprocs, procs)
               for pkg in ("tpu_mpi", "tpu_mpi_torch")}
    runs = {}
    for pkg, p in started.items():
        out, err = p.communicate(timeout=150)
        runs[pkg] = subprocess.CompletedProcess(p.args, p.returncode, out,
                                                err)
    return runs


@pytest.mark.parametrize("procs", [False, True], ids=["threads", "procs"])
def test_raising_rank_fails_run(tmp_path, procs):
    runs = _both(tmp_path, """
        import __PKG__ as MPI
        MPI.Init()
        comm = MPI.COMM_WORLD
        if MPI.Comm_rank(comm) == 1:
            raise RuntimeError("deliberate failure on rank 1")
        MPI.Barrier(comm)
        MPI.Finalize()
    """, 4 if not procs else 2, procs)
    for pkg, res in runs.items():
        assert res.returncode != 0, pkg
        assert "deliberate failure" in res.stderr + res.stdout, pkg


@pytest.mark.parametrize("procs", [False, True], ids=["threads", "procs"])
def test_clean_run_exits_zero(tmp_path, procs):
    runs = _both(tmp_path, """
        import __PKG__ as MPI
        MPI.Init()
        MPI.Barrier(MPI.COMM_WORLD)
        MPI.Finalize()
    """, 4 if not procs else 2, procs)
    for pkg, res in runs.items():
        assert res.returncode == 0, (pkg, res.stderr)


@pytest.mark.parametrize("procs", [False, True], ids=["threads", "procs"])
def test_sys_exit_code_propagates(tmp_path, procs):
    runs = _both(tmp_path, """
        import __PKG__ as MPI
        MPI.Init()
        raise SystemExit(7)
    """, 2, procs)
    for pkg, res in runs.items():
        assert res.returncode == 7, (pkg, res.returncode, res.stderr)


def test_install_tpurun(tmp_path):
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch.error import MPIError

    dest = MPI.install_tpurun(destdir=str(tmp_path), verbose=False)
    assert os.path.basename(dest) == "tpurun-torch"
    assert os.path.exists(dest) and os.access(dest, os.X_OK)
    assert "tpu_mpi_torch.launcher" in open(dest).read()
    with pytest.raises(MPIError):
        MPI.install_tpurun(destdir=str(tmp_path), verbose=False)
    MPI.install_tpurun(destdir=str(tmp_path), force=True, verbose=False)
    res = subprocess.run([dest, "--help"], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "SPMD" in res.stdout
    assert "tpurun-torch" in res.stdout


def test_console_script_is_named_in_pyproject():
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert 'tpurun-torch = "tpu_mpi_torch.launcher:main"' in text
    assert 'tpurun = "tpu_mpi.launcher:main"' in text


@pytest.mark.parametrize("flag", ["--serve", "--stats"])
def test_unported_subcommands_raise(flag, capsys):
    """``--serve`` and ``--stats`` reach the port's broker CLI and pvar
    reporter (no longer the not-ported refusal): each one's own argument
    parser answers ``--help`` and raises SystemExit(0)."""
    from tpu_mpi_torch import launcher
    with pytest.raises(SystemExit) as ei:
        launcher.main([flag, "--help"])
    assert ei.value.code == 0
    assert f"tpurun-torch {flag}" in capsys.readouterr().out


_CLIENT = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import tpu_mpi_torch as MPI
MPI.Init(session={addr!r})
s = MPI.serve.current_session()
x = torch.arange(6, dtype=torch.float32)
out = s.allreduce(x)
assert isinstance(out, np.ndarray)
assert out.tobytes() == (x.numpy() * 2).tobytes(), out
print("CLIENT", s.tenant, out.tolist(), flush=True)
MPI.Finalize()
assert MPI.serve.current_session() is None
"""


def test_serve_cli_broker_and_an_init_session_client_process(tmp_path):
    """``tpurun-torch --serve --device cpu`` runs a broker; a separate
    client process attaches through ``MPI.Init(session=addr)`` and
    Allreduces a torch tensor; ``--serve --stats`` reports its tenant."""
    env = _env({"TPU_MPI_SESSION_TOKEN": "tk"})
    broker = subprocess.Popen(
        [sys.executable, "-m", "tpu_mpi_torch.launcher", "--serve",
         "--nranks", "2", "--device", "cpu", "--token", "tk"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        line = broker.stdout.readline()
        assert "broker up" in line and "cpu" in line, \
            line + broker.stderr.read()
        addr = line.split("socket=")[1].split(",")[0]
        client = tmp_path / "client.py"
        client.write_text(_CLIENT.format(repo=REPO, addr=addr))
        res = subprocess.run([sys.executable, str(client)],
                             capture_output=True, text=True, env=env,
                             timeout=120, cwd=REPO)
        assert res.returncode == 0, res.stderr
        assert "[0.0, 2.0, 4.0, 6.0, 8.0, 10.0]" in res.stdout
        tenant = res.stdout.split()[1]
        st = subprocess.run(
            [sys.executable, "-m", "tpu_mpi_torch.launcher", "--serve",
             "--stats", "--socket", addr, "--token", "tk"],
            capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
        assert st.returncode == 0, st.stderr
        rep = json.loads(st.stdout)
        assert rep["ledger"]["tenants"][tenant]["detached"] is True
        assert rep["pool"]["device"] == "cpu"
    finally:
        broker.terminate()
        broker.communicate(timeout=60)


_STATS_BODY = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import tpu_mpi_torch as MPI
MPI.Init()
comm = MPI.COMM_WORLD
for _ in range(3):
    MPI.Allreduce(np.ones(512), MPI.SUM, comm)
MPI.Finalize()
"""


def test_stats_wraps_a_launch_with_dumping_on(tmp_path):
    """``tpurun-torch --stats -- <launch args>`` runs the launch with pvar
    dumps on and reports them."""
    script = tmp_path / "job.py"
    script.write_text(_STATS_BODY.format(repo=REPO))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_mpi_torch.launcher", "--stats", "--",
         "-n", "2", "--procs", "--sim", "1", "--timeout", "100",
         str(script)],
        capture_output=True, text=True, env=_env(), timeout=150, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "per-collective latency" in res.stdout
    assert "allreduce" in res.stdout


def test_tune_reaches_the_ports_tuner(tmp_path):
    """``tpurun-torch --tune`` runs the port's lockstep sweep on child
    processes and writes a table."""
    from tpu_mpi_torch import launcher
    table = tmp_path / "t.toml"
    rc = launcher.main(["--tune", "--nranks", "2", "--sizes", "1024",
                        "--colls", "allreduce", "--scale", "0.1",
                        "--out", str(table)])
    assert rc == 0
    assert "[allreduce.n2]" in table.read_text()


# ---------------------------------------------------------------------------
# The card binding
# ---------------------------------------------------------------------------

_SHOW_CARDS = """
import os, sys
sys.path.insert(0, {repo!r})
print(f"CARD-{{os.environ['TPU_MPI_PROC_RANK']}}="
      f"{{os.environ.get('CUDA_VISIBLE_DEVICES')}}", flush=True)
"""


def test_children_share_the_card_or_take_a_pool_entry(tmp_path):
    """CUDA is not process-exclusive: without a caller-set pool the children
    see every card (and pick ``rank % cards``); a caller-set
    ``CUDA_VISIBLE_DEVICES`` is the pool, child i taking entry i mod its
    length; ``--sim`` hides the cards."""
    path = tmp_path / "cards.py"
    path.write_text(_SHOW_CARDS.format(repo=REPO))

    def start(extra, sim):
        env = _env(extra)
        if "CUDA_VISIBLE_DEVICES" not in (extra or {}):
            env.pop("CUDA_VISIBLE_DEVICES", None)
        cmd = [sys.executable, "-m", "tpu_mpi_torch.launcher", "-n", "3",
               "--procs", "--timeout", "100"] + (["--sim", "1"] if sim else [])
        return subprocess.Popen(cmd + [str(path)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=REPO)

    # the three launches run side by side
    started = [start(None, False),
               start({"CUDA_VISIBLE_DEVICES": "4, 5"}, False),
               start({"CUDA_VISIBLE_DEVICES": "4,5"}, True)]
    outs = []
    for p in started:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out)
    out = outs[0]
    assert all(f"CARD-{r}=None" in out for r in range(3)), out
    out = outs[1]
    for r, card in enumerate(("4", "5", "4")):
        assert f"CARD-{r}={card}" in out, out
    out = outs[2]
    assert all(f"CARD-{r}=" in out and f"CARD-{r}=4" not in out
               for r in range(3)), out


def test_a_rank_without_a_card_fails_instead_of_running_on_the_cpu(tmp_path):
    """Without ``--sim`` a rank process must find CUDA: on a box without a
    card ``Init`` fails loudly (the job exits nonzero) instead of running on
    the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the ranks run on it")
    res = _launch(tmp_path, "tpu_mpi_torch", """
        MPI.Init()
        say("RAN")
    """, sim=False, timeout=100)
    assert res.returncode != 0
    assert "RAN" not in res.stdout
    assert "no CUDA device" in res.stderr and "--sim" in res.stderr, \
        res.stderr[-2000:]


def test_two_invocations_form_one_world_of_two_hosts(tmp_path):
    """Two launcher invocations (``--world-size``/``--rank-base``, one
    creating the coordinator on a fixed port, the other joining it) form
    one world of 4, each acting as a host of its own (``TPU_MPI_HOST_ID``):
    collectives and point-to-point of tensors cross it, Comm_split_type
    yields the per-host groups, a shared window works inside a host's
    group and is refused on the world, which spans two hosts."""
    import socket
    path = tmp_path / "world.py"
    path.write_text(PRELUDE.format(repo=REPO, pkg="tpu_mpi_torch")
                    + textwrap.dedent("""
        MPI.Init()
        comm = MPI.COMM_WORLD
        rank, size = comm.rank(), comm.size()
        assert size == 4, size
        total = MPI.Allreduce(torch.tensor([float(rank)]), MPI.SUM, comm)
        assert total[0] == 6.0, total
        rbuf = torch.zeros(1)
        MPI.Sendrecv(torch.tensor([float(rank)]), (rank + 1) % size, 3, rbuf,
                     (rank - 1) % size, 3, comm)
        assert rbuf[0] == (rank - 1) % size, (rank, rbuf)
        assert MPI.bcast({"from": 3} if rank == 3 else None, 3, comm) == \\
            {"from": 3}
        node = MPI.Comm_split_type(comm, MPI.COMM_TYPE_SHARED, rank)
        expect = [0, 1] if rank < 2 else [2, 3]
        assert list(node.group) == expect, (rank, node.group)
        win, local = MPI.Win_allocate_shared(np.float64, 4, node,
                                             device="cpu")
        local[:] = float(rank)
        MPI.Win_fence(0, win)
        nbytes, disp, slab = MPI.Win_shared_query(win, 1 - node.rank())
        assert (nbytes, disp) == (32, 8) and \\
            slab[0] == float(expect[1 - node.rank()]), (rank, slab)
        MPI.Win_fence(0, win)
        win.free()
        try:
            MPI.Win_allocate_shared(np.float64, 4, comm, device="cpu")
            raise SystemExit(f"rank {rank}: expected MPIError")
        except MPI.MPIError as e:
            assert "spans" in str(e), e
        say(f"HOSTS-OK-{rank}")
        MPI.Finalize()
    """))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    common = [sys.executable, "-m", "tpu_mpi_torch.launcher", "--procs",
              "--sim", "1", "--timeout", "120", "-n", "2", "--world-size", "4"]
    hosts = [subprocess.Popen(
        common + extra + [str(path)], env=_env({"TPU_MPI_HOST_ID": host}),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for host, extra in (
            ("hostA", ["--rank-base", "0", "--coord-port", str(port)]),
            ("hostB", ["--rank-base", "2", "--coordinator",
                       f"127.0.0.1:{port}"]))]
    outs = [h.communicate(timeout=150) for h in hosts]
    for h, (out, err) in zip(hosts, outs):
        assert h.returncode == 0, (out, err[-3000:])
    assert "HOSTS-OK-0" in outs[0][0] and "HOSTS-OK-1" in outs[0][0]
    assert "HOSTS-OK-2" in outs[1][0] and "HOSTS-OK-3" in outs[1][0]
