"""tpu_mpi_torch.train — the data-parallel training tier, the port of
``tpu_mpi/train``.

Two trainers over the host collective path, with float64 masters on a
device (default ``cuda``; ``device="cpu"`` runs the plain folds):

- :class:`DDPTrainer` (``ddp.py``): replicated state, bucketed gradient
  Allreduces on persistent handles ``Start``ed as each bucket fills and
  ``Wait``ed at the fold (`TPU_MPI_TRAIN_BUCKET_BYTES` sizes the buckets);
- :class:`FSDPTrainer` (``fsdp.py``): ZeRO-style sharded state
  (`TPU_MPI_TRAIN_SHARD_STATE`) — ``Reduce_scatter`` the grad,
  ``Allgather`` the updated params, optimizer state 1/nranks per rank.

:func:`make_trainer` picks between them from config. Checkpoints
(``save``/``load``) go through the port's ``checkpoint.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .. import config as _config
from .bucketer import Bucket, GradBucketer
from .ddp import DDPTrainer, arm_bucket
from .fsdp import FSDPTrainer

__all__ = ["Bucket", "GradBucketer", "DDPTrainer", "FSDPTrainer",
           "arm_bucket", "make_trainer"]


def make_trainer(params: Dict[str, Any], comm, *,
                 shard_state: Optional[bool] = None, **kw):
    """Build the configured trainer: FSDP when ``shard_state`` (default:
    `TPU_MPI_TRAIN_SHARD_STATE`), else DDP. Keyword args pass through."""
    if shard_state is None:
        shard_state = _config.load().train_shard_state
    if shard_state:
        kw.pop("bucket_bytes", None)
        kw.pop("overlap", None)
        kw.pop("grad_order", None)
        return FSDPTrainer(params, comm, **kw)
    return DDPTrainer(params, comm, **kw)
