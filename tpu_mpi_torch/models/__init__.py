"""Models built on the port's parallelism recipes: the data-parallel MLP of
``tpu_mpi/models/mlp.py`` and the flagship transformer of
``tpu_mpi/models/transformer.py``, forward and train steps."""

from .mlp import mlp_init, mlp_train_step_dp
from .transformer import (TransformerConfig, params_from_jax, shard_params,
                          transformer_forward, transformer_init,
                          transformer_param_specs, transformer_train_step)
