"""tpurun-torch: the port's SPMD launcher (the mpiexecjl analog).

Reference: MPI.jl bin/mpiexecjl (sh, :29-64) resolves the right mpiexec and
forks N OS processes each running ``julia script.jl``; ranks are bound by
libmpi at MPI_Init. Launch model (SURVEY.md §3.5):

- rank threads: ONE controller process runs the script on N rank threads
  sharing the card (rank i ↔ card i % cards) — ``tpurun-torch -n 4
  script.py``;
- rank processes: ``--procs`` forks one OS process per rank over the native
  transport (``tpu_mpi_torch.backend``); the processes of a one-card host
  share the card, each its own CUDA context. ``python -m
  tpu_mpi_torch.launcher`` is the same command;
- ``--sim N`` places the ranks on the CPU (the cards are hidden from them)
  — the "cluster on a laptop" mode the reference gets from
  ``--oversubscribe``, and how the tests run. Without it a rank process
  that finds no CUDA device fails at ``Init`` rather than running on the
  CPU;
- multi-host: one process per rank over the network, each host launching
  its share with ``--world-size``/``--rank-base``/``--coordinator``.

Each rank executes the script the way ``runpy`` runs ``__main__``, with its
own module namespace; a nonzero exit of any rank fails the whole run
(test/runtests.jl:37-39 semantics).
"""

from __future__ import annotations

import argparse
import os
import time
import runpy
import sys
from typing import Optional

from ._runtime import spmd_run
from .error import MPIError

# Distinct job exit codes for the fault-tolerant launch mode
# (TPU_MPI_HEARTBEAT_MS > 0; docs/fault-tolerance.md):
# EXIT_SHRUNK_OK  — a rank died by signal, but every survivor finished
#                   cleanly (revoked + shrunk + completed).
# EXIT_RANK_FAILED — a rank failed and the job did NOT recover (a survivor
#                   also exited nonzero, or the failure wasn't a signal).
# Elastic-resize outcomes (docs/fault-tolerance.md "Elastic recovery";
# used by the serve tier's chaos benchmark, benchmarks/elastic_chaos.py):
# EXIT_RESIZED_OK — ranks were lost AND the autoscaler restored full
#                   capacity (degraded → re-spawn → rebind) with zero
#                   dropped tenants.
# EXIT_DEGRADED   — ranks were lost and the pool is still serving degraded
#                   (capacity not yet restored when the run ended).
EXIT_SHRUNK_OK = 66
EXIT_RANK_FAILED = 65
EXIT_RESIZED_OK = 67
EXIT_DEGRADED = 68


def _cpu_env(env: dict) -> None:
    """``--sim``: place a process on the CPU. Hides the cards (CUDA reads
    the variable when it first initialises, so in this process it must run
    before then) and tells ``backend.proc_attach`` the CPU was asked for."""
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["TPU_MPI_PROC_DEVICE"] = "cpu"


def launch_script(path: str, nprocs: int, script_args: Optional[list[str]] = None,
                  timeout: Optional[float] = None) -> None:
    """Run a Python script as an SPMD program on nprocs rank threads."""
    argv = [path] + list(script_args or [])

    def rank_main() -> None:
        runpy.run_path(path, run_name="__main__")

    # sys.argv is process-global; set it once around the whole SPMD run
    # rather than per rank-thread (a per-thread restore races with ranks
    # still running).
    old_argv = sys.argv
    sys.argv = list(argv)
    try:
        spmd_run(rank_main, nprocs, timeout=timeout)
    finally:
        sys.argv = old_argv


class Rendezvous:
    """The address-map bootstrap, factored so the classic ``tpurun --procs``
    path and the serve broker's process pool (docs/serving.md) share one
    implementation: children report their transport ports to a coordinator
    and every child receives the full world address map.

    Two construction modes mirror the two launch shapes:

    - ``Rendezvous(world, ...)`` creates the coordinator (first host /
      broker) — a :class:`tpu_mpi_torch.backend.Coordinator` under the hood;
    - ``Rendezvous.join(addr, world)`` wraps an existing coordinator's
      address (hosts 2..H of a multi-host job) — same ``child_env`` surface,
      no local server.

    ``child_env(rank)`` builds the complete child environment: the
    ``TPU_MPI_PROC_{RANK,SIZE,COORD}`` rendezvous triple, a PYTHONPATH
    that resolves this tpu_mpi_torch wherever the script lives, the
    exported frame-size knob, and the CPU placement when requested.
    """

    def __init__(self, world: int, *, port: int = 0,
                 host: Optional[str] = None,
                 advertise: Optional[str] = None,
                 rank_base: int = 0,
                 base_addrs: Optional[list[str]] = None):
        from . import config
        from .backend import Coordinator
        cfg = config.load()
        self.world = world
        self.coordinator = Coordinator(
            world, host=host or cfg.coordinator_bind, port=port,
            advertise=advertise if advertise is not None
            else (cfg.coordinator_advertise or None),
            rank_base=rank_base, base_addrs=base_addrs)
        self.address = self.coordinator.address
        self._swept = False

    @classmethod
    def join(cls, address: str, world: int) -> "Rendezvous":
        """An already-running coordinator elsewhere; this instance only
        builds child environments pointing at it."""
        self = cls.__new__(cls)
        self.world = world
        self.coordinator = None
        self.address = address
        self._swept = False
        return self

    def child_env(self, rank: int, *, sim: Optional[int] = None,
                  extra: Optional[dict] = None) -> dict:
        from . import config
        cfg = config.load()
        env = dict(os.environ)
        # Children run `python script.py`, whose sys.path[0] is the script's
        # directory — make sure they can import this package no matter where
        # the script lives (the mpiexecjl --project flag analog).
        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        old_pp = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = pkg_parent + (os.pathsep + old_pp if old_pp else "")
        env["TPU_MPI_PROC_RANK"] = str(rank)
        env["TPU_MPI_PROC_SIZE"] = str(self.world)
        env["TPU_MPI_PROC_COORD"] = self.address
        # The native transport reads knobs from the environment only;
        # export the merged config so TOML-persisted values reach children.
        env.setdefault("TPU_MPI_MAX_FRAME_BYTES", str(cfg.max_frame_bytes))
        if sim is not None:
            _cpu_env(env)
        if extra:
            env.update(extra)
        return env

    def wait_map(self, timeout: float) -> list[str]:
        """Block until every expected registrant arrived; the full world
        address table."""
        if self.coordinator is None:
            raise MPIError("wait_map on a joined Rendezvous (the map lives "
                           "at the remote coordinator)")
        return self.coordinator.wait_map(timeout)

    def close(self, sweep: bool = False) -> None:
        """Stop the coordinator; ``sweep=True`` additionally reclaims
        shm-lane segments orphaned by crashed children — only safe once
        every child is really gone (a rank still mid-spill would recreate
        segments after the sweep)."""
        if self.coordinator is not None:
            self.coordinator.close()
        if sweep and not self._swept:
            self._swept = True
            from .backend import sweep_segments
            sweep_segments(self.address.rsplit(":", 1)[-1])


def launch_processes(path: str, nprocs: int,
                     script_args: Optional[list[str]] = None,
                     timeout: Optional[float] = None,
                     sim: Optional[int] = None,
                     world_size: Optional[int] = None,
                     rank_base: int = 0,
                     coordinator: Optional[str] = None,
                     coord_port: int = 0) -> int:
    """Run a script as N OS processes over the native transport (the
    reference's actual launch model, bin/mpiexecjl:55-64: mpiexec forks N
    processes; ranks bind at Init). Returns the job exit code; any rank
    failing nonzero fails the job, mpiexec-style.

    Multi-host (SURVEY §3.5 "multi-host → per-host processes"): one tpurun
    invocation per host, each launching its local share of a bigger world —
    ``world_size`` = total ranks, ``rank_base`` = this host's first rank.
    The first host creates the rendezvous Coordinator (bind/advertise from
    config, fixed ``coord_port`` so peers can be pointed at it); the others
    pass ``coordinator="host:port"`` and join it.
    """
    import signal
    import subprocess

    world = world_size if world_size is not None else nprocs
    if not (0 <= rank_base and rank_base + nprocs <= world):
        raise MPIError(f"local ranks [{rank_base}, {rank_base + nprocs}) "
                       f"outside world of {world}")
    if coordinator is None:
        rdv = Rendezvous(world, port=coord_port)
        if world > nprocs:
            # remaining hosts need this address; print it where a wrapping
            # scheduler can scrape it
            print(f"tpurun-torch: coordinator at {rdv.address} "
                  f"(waiting for {world - nprocs} remote ranks)",
                  file=sys.stderr, flush=True)
    else:
        rdv = Rendezvous.join(coordinator, world)
    coord_addr = rdv.address
    procs: list[subprocess.Popen] = []
    try:
        for rank in range(rank_base, rank_base + nprocs):
            env = rdv.child_env(rank, sim=sim)
            if sim is None:
                # CUDA is not process-exclusive: rank processes may share a
                # card, and on a one-card host they all do (each picks
                # cuda:(rank % cards), ProcContext.device_for). A
                # caller-set CUDA_VISIBLE_DEVICES is the card POOL: child i
                # of this invocation sees the (i % pool)-th entry alone —
                # never an index the host lacks.
                cards = [c.strip() for c in
                         env.get("CUDA_VISIBLE_DEVICES", "").split(",")
                         if c.strip()]
                if cards:
                    env["CUDA_VISIBLE_DEVICES"] = \
                        cards[(rank - rank_base) % len(cards)]
            procs.append(subprocess.Popen(
                [sys.executable, path] + list(script_args or []), env=env))
        code = 0
        # Fault-tolerant mode: with the failure detector enabled in the
        # children (TPU_MPI_HEARTBEAT_MS > 0), a dead rank is the SCRIPT's
        # problem — survivors detect it, revoke, shrink and continue — so
        # the launcher must not fate-share-kill them. Without it, the
        # classic mpiexec behavior stands: one rank fails, all die.
        try:
            ft_mode = int(os.environ.get("TPU_MPI_HEARTBEAT_MS", "0") or 0) > 0
        except ValueError:
            ft_mode = False
        failures: list[tuple[int, int]] = []      # (rank, returncode)
        deadline = None if timeout is None else (time.monotonic() + timeout)
        pending = list(procs)
        while pending:
            for p in list(pending):
                rc = p.poll()
                if rc is None:
                    continue
                pending.remove(p)
                if rc != 0:
                    rank = rank_base + procs.index(p)
                    if rc < 0:
                        try:
                            desc = f"signal {signal.Signals(-rc).name}"
                        except ValueError:
                            desc = f"signal {-rc}"
                    else:
                        desc = f"exit code {rc}"
                    stamp = time.strftime("%Y-%m-%dT%H:%M:%S",
                                          time.localtime())
                    print(f"tpurun-torch: rank {rank} died ({desc}) at {stamp}"
                          + ("" if failures else " [first failure]"),
                          file=sys.stderr, flush=True)
                    failures.append((rank, rc))
                    if ft_mode:
                        continue          # survivors shrink and carry on
                    if code == 0:
                        code = rc
                        # fate-sharing: one rank failed, kill the rest
                        for q in pending:
                            q.terminate()
            if pending:
                if deadline is not None and time.monotonic() > deadline:
                    for q in pending:
                        q.terminate()
                    code = code or 124
                    break
                try:
                    pending[0].wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    pass
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        if ft_mode and failures and code == 0:
            # Distinct exit codes for the two fault outcomes: survivors all
            # finished cleanly after a signal death (revoked + shrunk +
            # completed) vs. the job genuinely failing.
            only_signals = all(rc < 0 for _, rc in failures)
            survivors_ok = len(failures) < nprocs
            code = (EXIT_SHRUNK_OK if only_signals and survivors_ok
                    else EXIT_RANK_FAILED)
        return code
    finally:
        rdv.close()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        # Sweep shm-lane segments orphaned by a crashed/killed rank — but
        # only once every child is really gone, or a rank still mid-spill
        # would recreate segments after the sweep (a clean run unlinks every
        # segment at receive time; see backend._shm_load).
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        rdv.close(sweep=True)


def install_tpurun(command: str = "tpurun-torch",
                   destdir: Optional[str] = None,
                   force: bool = False, verbose: bool = True) -> str:
    """Install a ``tpurun``-style wrapper executable (the install_mpiexecjl
    analog, src/mpiexec_wrapper.jl:12-26): a small script that launches
    this interpreter's ``tpu_mpi_torch.launcher`` with the caller's
    arguments. Returns the installed path."""
    if destdir is None:
        destdir = os.path.join(os.path.expanduser("~"), ".local", "bin")
    destdir = os.path.abspath(os.path.expanduser(destdir))
    exec_path = os.path.join(destdir, command)
    if os.path.exists(exec_path) and not force:
        raise MPIError(f"file {exec_path!r} already exists; "
                       f"use install_tpurun(force=True) to overwrite")
    os.makedirs(destdir, exist_ok=True)
    if verbose:
        print(f"Installing {command!r} to {destdir!r}...")
    script = ("#!/bin/sh\n"
              f"exec \"{sys.executable}\" -m tpu_mpi_torch.launcher \"$@\"\n")
    with open(exec_path, "w") as f:
        f.write(script)
    os.chmod(exec_path, 0o755)
    if verbose:
        print("Done!")
    return exec_path


def main(argv: Optional[list[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--tune"]:
        # `tpurun-torch --tune [...]` — the collective-algorithm autotuner
        # (tpu_mpi_torch.tune): sweep the portfolio on this substrate and write
        # a tuning table; `--tune merge` folds pvar dumps + tables into
        # the shared fleet database, `--tune sentinel` replays committed
        # artifacts as a regression check, and `--tune --online <dumps>`
        # reports the online bandit's exploration. All following args
        # belong to the tuner.
        from . import tune
        return tune.main(argv[1:])
    if argv[:1] == ["--serve"]:
        # `tpurun-torch --serve [...]` — the multi-tenant broker daemon
        # (tpu_mpi_torch.serve): own a warm world on the card and lease
        # slices of it to client sessions; `--serve --stats` queries a
        # running broker's per-tenant ledger. All following args belong
        # to the broker CLI.
        from .serve import broker
        return broker.main(argv[1:])
    if argv[:1] == ["--stats"]:
        # `tpurun-torch --stats <dumps...>` / `tpurun-torch --stats --
        # <launch args>` — the pvar report CLI (tpu_mpi_torch.stats):
        # aggregate per-rank counter dumps into latency/bandwidth tables,
        # or wrap a whole launch with dumping enabled. All following args
        # belong to the reporter.
        from . import stats
        return stats.main(argv[1:])
    p = argparse.ArgumentParser(
        prog="tpurun-torch",
        description="Run an SPMD tpu_mpi_torch program on N ranks (mpiexec "
                    "analog); `tpurun-torch --tune` runs the collective "
                    "autotuner")
    from . import config
    cfg = config.load()
    p.add_argument("-n", "--np", type=int, default=cfg.nprocs or None,
                   help="number of ranks (default: number of local cards)")
    p.add_argument("--sim", type=int, default=None, metavar="N",
                   help="place the ranks on the CPU (test mode; N is the "
                        "rank count when -n is not given); backend=cpu-sim "
                        "in the config applies this by default")
    p.add_argument("--procs", action="store_true",
                   help="one OS process per rank over the native transport "
                        "(multi-host deployment shape) instead of rank threads")
    p.add_argument("--world-size", type=int, default=None, metavar="N",
                   help="total ranks across every host (multi-host --procs); "
                        "default: -n (single-host world)")
    p.add_argument("--rank-base", type=int, default=0, metavar="K",
                   help="first world rank launched by this invocation "
                        "(multi-host --procs)")
    # no config default here: cfg.coordinator maps TPU_MPI_PROC_COORD, the
    # env the launcher sets FOR children — a nested tpurun inheriting it
    # would register with the parent job's coordinator
    p.add_argument("--coordinator", default=None,
                   metavar="HOST:PORT",
                   help="join an existing rendezvous coordinator instead of "
                        "creating one (hosts 2..H of a multi-host job)")
    p.add_argument("--coord-port", type=int, default=0, metavar="P",
                   help="fixed port for the coordinator this invocation "
                        "creates (so other hosts can be pointed at it)")
    p.add_argument("--timeout", type=float, default=None,
                   help="abort the job after SECONDS")
    p.add_argument("--probe", action="store_true",
                   help="print the platform probe (backend, generation, "
                        "topology, capabilities) as JSON and exit")
    p.add_argument("script", nargs="?",
                   help="Python script to run on every rank")
    p.add_argument("script_args", nargs=argparse.REMAINDER,
                   help="arguments passed to the script")
    args = p.parse_args(argv)

    if args.probe:
        import json
        # same cpu-sim defaulting as a real launch, so the probe reports
        # the platform a job would actually run on
        if args.sim is None and cfg.backend == "cpu-sim":
            args.sim = cfg.sim_devices
        if args.sim is not None:
            _cpu_env(os.environ)
        from .implementations import platform_probe
        print(json.dumps(platform_probe(), indent=2))
        return 0
    if args.script is None:
        p.error("script is required (or use --probe)")

    if args.sim is None and config.load().backend == "cpu-sim":
        args.sim = config.load().sim_devices
    if args.sim is not None:
        _cpu_env(os.environ)
        if args.np is None:
            args.np = args.sim
    if args.np is None:
        import torch
        args.np = max(1, torch.cuda.device_count())
    try:
        if args.procs:
            return launch_processes(args.script, args.np, args.script_args,
                                    timeout=args.timeout, sim=args.sim,
                                    world_size=args.world_size,
                                    rank_base=args.rank_base,
                                    coordinator=args.coordinator,
                                    coord_port=args.coord_port)
        if args.world_size is not None or args.rank_base or args.coordinator:
            raise MPIError("--world-size/--rank-base/--coordinator require --procs")
        launch_script(args.script, args.np, args.script_args, timeout=args.timeout)
    except SystemExit as e:
        if e.code is None:
            return 0
        if isinstance(e.code, int):
            return e.code
        print(e.code, file=sys.stderr)   # sys.exit("message") idiom
        return 1
    except MPIError as e:
        print(f"tpurun-torch: job failed: {e}", file=sys.stderr)
        return getattr(e, "code", 1) or 1
    except BaseException as e:
        print(f"tpurun-torch: job failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
