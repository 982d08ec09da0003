"""Environment / lifecycle: Init, Finalize, Abort, thread levels, wall clock.

Reference: MPI.jl src/environment.jl — Init (:80-89), Init_thread +
ThreadLevel (:111-162), Query_thread (:173-180), Is_thread_main (:191-197),
Finalize (:220-236), Abort (:252-254), Initialized/Finalized (:267-287),
Wtick/Wtime (:289-295), has_cuda (:308-323).

Port mapping: there is no C library to spin up. ``Init`` attaches the
calling rank-thread to the ambient :class:`~tpu_mpi_torch._runtime.SpmdContext`
(created by ``spmd_run``/``tpurun``); run standalone it creates a singleton
world of size 1, exactly like running an MPI program without mpiexec. The
reference's REFCOUNT machinery (src/environment.jl:26-62) exists to defer
MPI_Finalize past C-object finalizers; with no C resources we keep only the
init-once / finalize-once contract and the query functions.
"""

from __future__ import annotations

import enum
import os
import threading
import time
from typing import Optional

from . import _runtime
from ._runtime import SpmdContext, current_env, require_env, set_env
from .error import AbortError, MPIError


class ThreadLevel(enum.IntEnum):
    """Thread support levels (src/environment.jl:111-116)."""
    THREAD_SINGLE = 0
    THREAD_FUNNELED = 1
    THREAD_SERIALIZED = 2
    THREAD_MULTIPLE = 3


THREAD_SINGLE = ThreadLevel.THREAD_SINGLE
THREAD_FUNNELED = ThreadLevel.THREAD_FUNNELED
THREAD_SERIALIZED = ThreadLevel.THREAD_SERIALIZED
THREAD_MULTIPLE = ThreadLevel.THREAD_MULTIPLE


def Init(session: "str | None" = None) -> None:
    """Initialize the environment on this rank (src/environment.jl:80-89).

    Must be called exactly once per rank before any communication. Under
    ``spmd_run``/``tpurun`` it attaches to the launcher's world; standalone it
    creates a world of size 1.

    ``session=`` is the serve-tier attach path: instead of paying a cold
    start, the process attaches to a running ``tpurun-torch --serve``
    broker at the given address (or ``TPU_MPI_SERVE_SOCKET`` when the
    string is empty) and receives a lease on the broker's warm world. The
    attached :class:`~tpu_mpi_torch.serve.ClientSession` is reachable via
    ``MPI.serve.current_session()`` and is detached by ``Finalize``.
    """
    Init_thread(ThreadLevel.THREAD_MULTIPLE, session=session)


def Init_thread(required: ThreadLevel,
                session: "str | None" = None) -> ThreadLevel:
    """Initialize requesting a thread level (src/environment.jl:148-162).

    The host runtime is thread-safe by construction (it *is* threads), so the
    granted level is always THREAD_MULTIPLE. See :func:`Init` for the
    ``session=`` serve-tier attach path.
    """
    if session is not None:
        from . import serve
        if serve.current_session() is not None:
            raise MPIError("MPI.Init(session=...) but a session is already "
                           "attached on this process")
        serve._set_current(serve.attach(session or None))
    env = current_env()
    if env is None:
        if os.environ.get("TPU_MPI_PROC_RANK") is not None:
            # Launched as one process of a multi-process world
            # (tpurun-torch --procs): rendezvous over the native transport.
            from .backend import proc_attach
            env = proc_attach()
        else:
            ctx = SpmdContext(1)
            set_env((ctx, 0))
            env = (ctx, 0)
    ctx, rank = env
    if ctx.initialized[rank]:
        raise MPIError("MPI.Init() was already called on this rank")
    if ctx.finalized[rank]:
        raise MPIError("MPI.Init() called after MPI.Finalize()")
    ctx.initialized[rank] = True
    ctx.thread_level[rank] = ThreadLevel(required)
    ctx.main_threads[rank] = threading.get_ident()
    return ThreadLevel.THREAD_MULTIPLE


def Query_thread() -> ThreadLevel:
    """Granted thread level (src/environment.jl:173-180)."""
    require_env()
    return ThreadLevel.THREAD_MULTIPLE


def Is_thread_main() -> bool:
    """True on the thread that called Init (src/environment.jl:191-197)."""
    ctx, rank = require_env()
    return ctx.main_threads[rank] == threading.get_ident()


def Initialized() -> bool:
    """Whether Init has been called on this rank (src/environment.jl:267-273)."""
    env = current_env()
    if env is None:
        return False
    ctx, rank = env
    return ctx.initialized[rank]


def Finalized() -> bool:
    """Whether Finalize has been called on this rank (src/environment.jl:281-287)."""
    env = current_env()
    if env is None:
        return False
    ctx, rank = env
    return ctx.finalized[rank]


def Finalize() -> None:
    """Tear down the environment on this rank (src/environment.jl:220-236).

    After this, communication calls on this rank raise. Unlike the reference
    there are no C finalizers to sequence, so no refcount dance is needed.
    """
    ctx, rank = require_env()
    if not ctx.initialized[rank]:
        raise MPIError("MPI.Finalize() before MPI.Init()")
    if ctx.finalized[rank]:
        raise MPIError("MPI.Finalize() was already called on this rank")
    # detach the serve-tier session Init(session=...) opened, releasing the
    # lease cleanly (broker reclaims the cid namespace as detached)
    import sys
    serve = sys.modules.get("tpu_mpi_torch.serve")
    if serve is not None and serve.current_session() is not None:
        serve.current_session().detach()
        serve._set_current(None)
    # reclaim every I-collective worker this rank created (one thread per
    # communicator that saw a nonblocking collective)
    from .collective import nb_shutdown
    nb_shutdown(ctx, world_rank=rank)
    # flush this rank's perf counters when a dump dir is configured
    # (TPU_MPI_PVARS_DUMP) — one branch when pvars are off
    from . import perfvars
    perfvars.finalize_dump()
    # likewise flush this rank's event trace (TPU_MPI_TRACE_DUMP) for
    # offline schedule exploration — a no-op unless tracing is on
    from .analyze import events as _trace_events
    _trace_events.finalize_dump()
    ctx.finalized[rank] = True


def Abort(comm=None, errorcode: "int | None" = None) -> None:
    """Terminate the whole job (src/environment.jl:252-254).

    Fate-shares: every rank blocked in the runtime raises AbortError. In the
    multi-process launcher the process additionally exits with ``errorcode``.
    With no explicit errorcode the AbortError carries ERR_ABORTED (code 1
    would collide with MPI_ERR_BUFFER in the error-class table).
    """
    env = current_env()
    if env is None:
        raise SystemExit(1 if errorcode is None else errorcode)
    ctx, rank = env
    suffix = "" if errorcode is None else f" with errorcode {errorcode}"
    err = AbortError(f"MPI.Abort called on rank {rank}{suffix}")
    if errorcode is not None:
        err.code = errorcode
    ctx.fail(err, rank)
    raise err


def Wtime() -> float:
    """High-resolution wall clock in seconds (src/environment.jl:295)."""
    return time.perf_counter()


_measured_tick: Optional[float] = None


def Wtick() -> float:
    """Resolution of Wtime (src/environment.jl:289).

    Returns the platform's ADVERTISED ``perf_counter`` resolution when it is
    plausible (strictly between 0 and 1 second — the MPI contract: Wtick is
    the seconds between ticks, and e.g. Windows advertises a bogus 1e-7 /
    some platforms report whole seconds). Otherwise falls back to a MEASURED
    tick — the minimum nonzero delta observed over a short spin — cached for
    the life of the process.
    """
    res = time.get_clock_info("perf_counter").resolution
    if 0.0 < res < 1.0:
        return res
    global _measured_tick
    if _measured_tick is None:
        best = 1.0
        for _ in range(1000):
            a = time.perf_counter()
            b = time.perf_counter()
            while b == a:           # spin until the clock visibly advances
                b = time.perf_counter()
            if b - a < best:
                best = b - a
        _measured_tick = best
    return _measured_tick


def Pcontrol(level: int) -> int:
    """MPI-standard profiling-level control, wired to the pvar subsystem
    (docs/observability.md): ``Pcontrol(0)`` disables counter collection,
    ``Pcontrol(1)`` restores the configured default (the ``pvars`` knob),
    and ``Pcontrol(level >= 2)`` enables collection AND immediately flushes
    a per-rank dump to ``pvars_dump`` (when set). Returns the effective
    collection level."""
    from . import perfvars
    return perfvars.pcontrol(level)


class profile_trace:
    """Context manager wrapping ``torch.profiler``: host spans and CUDA
    kernels (the fold kernel included) issued inside the block land in a
    Chrome trace under ``logdir`` (view with Perfetto or chrome://tracing).
    The concrete form of SURVEY.md §5's tracing subsystem — the reference
    has only Wtime/Wtick and points users at external PMPI tools.

    The profiler is a process singleton: under the thread-rank tier only
    the designated rank (default world rank 0) starts it and the rest no-op,
    so every rank can execute the same ``with`` block. Callers outside SPMD
    always trace. ``self.profile`` holds the finished profile
    (``key_averages()`` etc.) after the block.

    >>> with MPI.profile_trace("/tmp/trace"):
    ...     step(params, batch)
    """

    def __init__(self, logdir: str, rank: int = 0):
        self.logdir = logdir
        self.rank = rank
        self.profile = None

    def __enter__(self):
        env = current_env()
        if env is None or env[1] == self.rank:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=acts)
            self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        if self.profile is not None:
            self.profile.__exit__(*exc)
            os.makedirs(self.logdir, exist_ok=True)
            name = f"trace-rank{self.rank}-{os.getpid()}.json"
            self.profile.export_chrome_trace(os.path.join(self.logdir, name))
        return False


def universe_size() -> Optional[int]:
    """Max processes the runtime can host (src/comm.jl:171-181 attribute)."""
    ctx, _ = require_env()
    return ctx.universe_size


def has_cuda() -> bool:
    """Whether a CUDA device is attached (has_cuda, src/environment.jl:
    308-323, including the env-var override ``TPU_MPI_HAS_CUDA``)."""
    flag = os.environ.get("TPU_MPI_HAS_CUDA")
    if flag is not None:
        return flag.lower() in ("1", "true", "yes")
    import torch
    return torch.cuda.is_available()
