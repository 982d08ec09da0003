"""Models built on the port's parallelism recipes (forward): the flagship
transformer of ``tpu_mpi/models/transformer.py``."""

from .transformer import (TransformerConfig, params_from_jax, shard_params,
                          transformer_forward, transformer_init,
                          transformer_param_specs)
