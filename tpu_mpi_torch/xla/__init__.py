"""tpu_mpi_torch.xla: the in-graph collective tier of the port.

The counterpart of ``tpu_mpi.xla``. There, MPI operations run as XLA
collectives inside ``shard_map`` over a mesh axis; here the n ranks of a
mesh share one card and every function takes the stacked per-rank tensor,
rank axis first, ``(n, *local_shape)``, and returns the stacked per-rank
results. Every kernel of the JAX package's ``pallas_kernels`` is reachable
here under its JAX name (the rings, the fused fold, ``pairwise_alltoall``,
``collective_permute``, ``ring_attention``), as a hand-written CUDA kernel
on a CUDA tensor and as its plain PyTorch version on a CPU tensor:

    mesh = xla.make_mesh({"x": 4})                # ranks on the card
    xs = torch.randn(4, 1 << 20, device=mesh.device)
    total = xla.allreduce(xs, MPI.SUM, axis="x")  # (4, 1 << 20)
    shards = xla.ring_reduce_scatter(xs)          # (4, 1 << 18)
"""

from .mesh import Mesh, comm_mesh, local_device_count, make_mesh, world_mesh
from .collectives import (allgather, allgatherv, allreduce, alltoall,
                          alltoallv, barrier, bcast, exscan, gather, gatherv,
                          rank, reduce, reduce_scatter, ring_shift, scan,
                          scatter, scatterv, sendrecv, size)
from ..kernels.attention import ring_attention
from ..kernels.fused_reduce import fused_multi_reduce
from ..kernels.permute import collective_permute, pairwise_alltoall
from ..kernels.ring import ring_allgather, ring_allreduce, ring_reduce_scatter
