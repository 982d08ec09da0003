"""Parallelism strategies over the in-graph tier — the port of
``tpu_mpi/parallel`` (forward; the train-side pieces, ``dp.py`` and the
f/g operators of ``tp.py``, come with the training slice).

Every function takes stacked per-rank tensors, rank axis first, as
:mod:`tpu_mpi_torch.xla` does:

- tensor parallel (tp.py)      <- psum through the fused fold kernel
- sequence parallel (ring.py, ulysses.py) <- the ring-attention kernel /
  the pairwise all-to-all kernel
- expert parallel (ep.py)      <- padded all-to-all with capacity masks
- pipeline parallel (pp.py)    <- ring_shift microbatch rotation (permute kernel)
- halo exchange (halo.py)      <- neighbour exchange (permute kernel)
"""

from .tp import all_gather_output, column_parallel, row_parallel
from .ring import ring_attention
from .ulysses import heads_to_seq, seq_to_heads, ulysses_attention
from .ep import moe_dispatch_combine
from .pp import pipeline_forward
from .halo import halo_exchange
