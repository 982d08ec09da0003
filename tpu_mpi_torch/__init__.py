"""tpu_mpi_torch: the PyTorch and CUDA port of tpu_mpi.

It carries the host path of the MPI.jl-shaped API (MPI.jl src/MPI.jl):
ranks are threads of one controller process that share one CUDA device;
collectives rendezvous through the host engine with zero-copy placement,
and the rank-ordered reduction fold runs as one hand-written CUDA kernel
(:mod:`tpu_mpi_torch.kernels.fused_reduce`); point-to-point messages go
through the host matching engine, and Cartesian communicators give them
their neighbours.
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

from ._runtime import ANY_SOURCE, ANY_TAG, PROC_NULL, SpmdContext, spmd_run
from .error import (AbortError, CollectiveMismatchError, DeadlockError,
                    InvalidCommError, MPIError)

# Environment / lifecycle (src/environment.jl)
from .environment import (Finalize, Finalized, Init, Initialized, Wtime,
                          has_cuda, profile_trace)

# Communicators (src/comm.jl)
from .comm import COMM_SELF, COMM_WORLD, Comm, Comm_dup, Comm_rank, Comm_size

# Object model
from .buffers import (Buffer, Buffer_send, DeviceBuffer, IN_PLACE, from_numpy,
                      to_numpy)
from .operators import (BAND, BOR, BXOR, LAND, LOR, LXOR, MAX, MIN, Op, PROD,
                        SUM)

# Collectives of the slice (src/collective.jl) + persistent Allreduce (MPI-4)
from .collective import (Allreduce, Allreduce_init, Barrier, Bcast, Reduce,
                         Reduce_scatter, Reduce_scatter_block)
from .overlap import PersistentCollRequest

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
from .error import TruncationError

# Topology (src/topology.jl) + MPI-3 neighbourhood collectives
from .topology import (Cart_coords, Cart_create, Cart_get, Cart_rank,
                       Cart_shift, Cart_sub, CartComm, Cartdim_get,
                       Dims_create, Neighbor_allgather, Neighbor_alltoall)

from . import testing

MPI_LIBRARY = "tpu_mpi_torch"
MPI_VERSION = Get_version()
