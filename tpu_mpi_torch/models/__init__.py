"""Models built on the port's parallelism recipes: the data-parallel MLP of
``tpu_mpi/models/mlp.py`` and the flagship transformer of
``tpu_mpi/models/transformer.py`` (flat, pipelined MoE and 4-axis), forward
and train steps; and Moonlight-16B-A3B's block (latent attention,
fine-grained experts) with its expert-parallel train step."""

from .mlp import mlp_init, mlp_train_step_dp
from .moonlight import (MoonlightConfig, moonlight_forward, moonlight_init,
                        moonlight_shapes, moonlight_train_step)
from .transformer import (TransformerConfig, params_from_jax, shard_params,
                          transformer_4d_init, transformer_4d_specs,
                          transformer_4d_train_step, transformer_forward,
                          transformer_init, transformer_param_specs,
                          transformer_pp_moe_host_params,
                          transformer_pp_moe_init, transformer_pp_moe_specs,
                          transformer_pp_moe_train_step, transformer_train_step)
