"""tpu_mpi_torch: the PyTorch and CUDA port of tpu_mpi.

It carries the host path of the MPI.jl-shaped API (MPI.jl src/MPI.jl):
ranks are threads of one controller process that share one CUDA device;
collectives rendezvous through the host engine with zero-copy placement,
and the rank-ordered reduction fold runs as one hand-written CUDA kernel
(:mod:`tpu_mpi_torch.kernels.fused_reduce`); point-to-point messages go
through the host matching engine, and Cartesian communicators give them
their neighbours; parallel file I/O (``File``), sharded checkpoints
(``checkpoint``) and one-sided RMA windows (``Win_*``) work on tensors
where they live.
The main path:

    MPI.Init(); comm = MPI.COMM_WORLD
    MPI.Allreduce(x, y, MPI.SUM, comm)   # x, y: DeviceBuffer on cuda

Entry points run on the card unless the caller asks for the CPU
(``DeviceBuffer(v, device="cpu")``); without CUDA they raise. The package
imports torch and numpy, never jax, and nothing of tpu_mpi. Modules keep
the JAX package's names, so ``tpu_mpi_torch.collective`` is the
counterpart of ``tpu_mpi.collective``; the rest of the JAX package's
surface arrives slice by slice (ROADMAP.md).
"""

from .version import __version__

from . import implementations
from .implementations import Get_library_version, Get_version

# Wildcards / sentinels
from ._runtime import (ANY_SOURCE, ANY_TAG, PROC_NULL, UNDEFINED,
                       SpmdContext, spmd_run)
from .error import (AbortError, AnalyzerError, CollectiveMismatchError,
                    DeadlockError, Error_string, Get_error_string,
                    InvalidCommError, LockOrderError, MPIError,
                    ProcFailedError, QuotaExceededError, RevokedError,
                    ServeBusyError, SessionError, TruncationError)

# Communication-correctness analysis: the event IR and the RMA race detector
from . import analyze
from .analyze import Diagnostic

# Environment / lifecycle (src/environment.jl)
from .environment import (Abort, Finalize, Finalized, Init, Init_thread,
                          Initialized, Is_thread_main, Pcontrol, Query_thread,
                          THREAD_FUNNELED, THREAD_MULTIPLE, THREAD_SERIALIZED,
                          THREAD_SINGLE, ThreadLevel, Wtick, Wtime, has_cuda,
                          profile_trace, universe_size)

# Communicators (src/comm.jl)
from .comm import (COMM_NULL, COMM_SELF, COMM_TYPE_SHARED, COMM_WORLD,
                   CONGRUENT, Comm, Comm_agree, Comm_compare, Comm_dup,
                   Comm_get_parent, Comm_rank, Comm_revoke, Comm_shrink,
                   Comm_size, Comm_spawn, Comm_split, Comm_split_type,
                   Comparison, IDENT, Intercomm, Intercomm_merge, ROOT,
                   SIMILAR, UNEQUAL, free, spawn_argv)

# Object model
from .info import INFO_NULL, Info, infoval
from .buffers import (BUFFER_NULL, Buffer, Buffer_send, DeviceBuffer, IN_PLACE,
                      MPIComplex, MPIDatatype, MPIFloatingPoint, MPIInteger,
                      assert_minlength, from_numpy, to_numpy)
from .datatypes import (BFLOAT16, BOOL, BYTE, CHAR, COMPLEX64, COMPLEX128,
                        Datatype, FLOAT16, FLOAT32, FLOAT64, Get_address,
                        INT8, INT16, INT32, INT64, Types, UINT8, UINT16,
                        UINT32, UINT64, to_datatype)
from .operators import (BAND, BOR, BXOR, LAND, LOR, LXOR, MAX, MIN, NO_OP, Op,
                        PROD, REPLACE, SUM)

# Collectives (src/collective.jl) + nonblocking (MPI-3) + persistent (MPI-4)
from .collective import (Allgather, Allgatherv, Allreduce, Allreduce_init,
                         Alltoall, Alltoallv, Barrier, Barrier_init, Bcast,
                         Bcast_init, CollRequest, Exscan, Gather, Gatherv,
                         Iallgather, Iallreduce, Ialltoall, Ibarrier, Ibcast,
                         Iexscan, Igather, Ireduce, Iscan, Iscatter, Reduce,
                         Reduce_scatter, Reduce_scatter_block, Scan, Scatter,
                         Scatterv, bcast)
from .overlap import PersistentCollRequest
from . import overlap

# Point-to-point (src/pointtopoint.jl)
from .pointtopoint import (Cancel, Get_count, Get_error, Get_source, Get_tag,
                           Iprobe, Irecv, Isend, Isendrecv, Isendrecv_replace,
                           Parrived, PartitionedRequest, Pready, Pready_range,
                           Precv_init, Prequest, Probe, Psend_init, Recv,
                           Recv_init, Request, REQUEST_NULL, Send, Send_init,
                           Sendrecv, Sendrecv_replace, Start, Startall,
                           Status, STATUS_EMPTY, Test, Testall, Testany,
                           Testsome, Wait, Waitall, Waitany, Waitsome, irecv,
                           isend, recv, send)

# Parallel I/O (src/io.jl) — usage: MPI.File.open / read_at / write_at_all …
from . import io as File
from .io import FileHandle
# Sharded checkpoint/resume on top of the File layer
from . import checkpoint

# One-sided RMA (src/onesided.jl)
from .onesided import (Accumulate, Fetch_and_op, Get, Get_accumulate,
                       LOCK_EXCLUSIVE, LOCK_SHARED, LockType, Put, Win,
                       Win_allocate_shared, Win_attach, Win_create,
                       Win_create_dynamic, Win_detach, Win_fence, Win_flush,
                       Win_lock, Win_shared_query, Win_sync, Win_unlock)

# Topology (src/topology.jl) + MPI-3 neighbourhood collectives
from .topology import (Cart_coords, Cart_create, Cart_get, Cart_rank,
                       Cart_shift, Cart_sub, CartComm, Cartdim_get,
                       Dims_create, Neighbor_allgather, Neighbor_alltoall)

from . import testing


class _NullHandle:
    """A null handle (src/handle.jl null consts): each null is its own
    sentinel, so ``x is MPI.WIN_NULL`` cannot be confused with another
    handle kind or with a plain None default."""
    __slots__ = ("_name",)

    def __init__(self, name):
        self._name = name

    def __repr__(self):
        return self._name

    def __bool__(self):
        return False


DATATYPE_NULL = _NullHandle("DATATYPE_NULL")
OP_NULL = _NullHandle("OP_NULL")
WIN_NULL = _NullHandle("WIN_NULL")
FILE_NULL = _NullHandle("FILE_NULL")
MPI_LIBRARY = "tpu_mpi_torch"
MPI_VERSION = Get_version()


def __getattr__(name):
    if name == "MPI_LIBRARY_VERSION_STRING":
        return Get_library_version()
    if name == "serve":
        # lazy: the serve tier (broker + client sessions) is only paid for
        # by processes that use it
        import importlib
        return importlib.import_module(".serve", __name__)
    if name == "train":
        # lazy: the training tier is only paid for by processes that train
        import importlib
        return importlib.import_module(".train", __name__)
    raise AttributeError(f"module 'tpu_mpi_torch' has no attribute {name!r}")


def install_tpurun(*args, **kwargs):
    """Install the ``tpurun-torch`` wrapper executable (MPI.install_mpiexecjl
    analog). Lazy import: eagerly importing .launcher here would put it in
    sys.modules and make ``python -m tpu_mpi_torch.launcher`` warn and
    re-execute."""
    from .launcher import install_tpurun as _install
    return _install(*args, **kwargs)
