"""Continuous-batching expert-parallel MoE inference on the serve tier.

The broker (``tpurun-torch --serve --infer``) owns one :class:`InferEngine`
(per-rank model shards, paged KV caches, the step executor over the warm
pool) and one :class:`InferScheduler` (admission, SLO eviction,
continuous batching). Clients stream tokens through
``ClientSession.generate`` — see docs/serving.md, "Inference engine".
The port of ``tpu_mpi/infer``: the engine's weights, KV caches and rows
live on the pool's device.
"""

from .engine import Decode, InferEngine, Prefill, StepPlan
from .kvcache import (PagedKVCache, PartitionStreamReader,
                      PartitionStreamWriter)
from .scheduler import InferRequest, InferScheduler

__all__ = ["Decode", "InferEngine", "InferRequest", "InferScheduler",
           "PagedKVCache", "PartitionStreamReader", "PartitionStreamWriter",
           "Prefill", "StepPlan"]
