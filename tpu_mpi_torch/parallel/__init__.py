"""Parallelism strategies over the in-graph tier — the port of
``tpu_mpi/parallel``.

Every function takes stacked per-rank tensors, rank axis first, as
:mod:`tpu_mpi_torch.xla` does (what tp holds the same on every rank is
held once):

- data parallel (dp.py)        <- gradient psum through the fused fold kernel
- tensor parallel (tp.py)      <- the f/g pair, psum through the fused fold kernel
- sequence parallel (ring.py, ulysses.py) <- the ring-attention kernel /
  the pairwise all-to-all kernel
- expert parallel (ep.py)      <- padded all-to-all with capacity masks
- pipeline parallel (pp.py)    <- ring_shift microbatch rotation (permute kernel)
- halo exchange (halo.py)      <- neighbour exchange (permute kernel)
"""

from .dp import allreduce_grads, pmean_tree
from .tp import (all_gather_output, column_parallel, row_parallel,
                 tp_identity_fwd_psum_bwd, tp_psum_fwd_identity_bwd)
from .ring import ring_attention
from .ulysses import heads_to_seq, seq_to_heads, ulysses_attention
from .ep import moe_dispatch_combine
from .pp import pipeline_forward
from .halo import halo_exchange
