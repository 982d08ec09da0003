"""The port's flagship transformer forward (tpu_mpi_torch.models) against
tpu_mpi.models.transformer on the conftest's 8-device CPU mesh.

The JAX model's weights (from its own init) carry across through
``params_from_jax``, and the same numpy tokens go through both: single
device, sequence-parallel on {"sp": 4} (ring attention) and
tensor-parallel on {"tp": 4} (column/row-parallel through the fold), the
JAX forward under shard_map on the same one-axis meshes. Tolerance: atol
1e-4, the bound of the JAX package's own sharded-vs-single test
(tests/test_parallel.py:169), in float32.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from tpu_mpi import xla as jxla
from tpu_mpi.models import transformer as jtr
from tpu_mpi_torch.models import transformer as ttr

KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
JCFG = jtr.TransformerConfig(**KW)
TCFG = ttr.TransformerConfig(**KW)
B, T, N = 2, 32, 4


@functools.lru_cache(maxsize=None)
def _weights():
    params = jtr.transformer_init(jax.random.PRNGKey(0), JCFG)
    tokens = np.random.default_rng(20261016).integers(0, KW["vocab"], (B, T)) \
        .astype(np.int32)
    return params, tokens


def _port_params():
    params, _ = _weights()
    return ttr.params_from_jax(jax.tree_util.tree_map(np.asarray, params), TCFG,
                               "cpu")


def _mesh(axis):
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} devices")
    return jxla.make_mesh({axis: N})


def test_single_forward_matches():
    params, tokens = _weights()
    want = np.asarray(jtr.transformer_forward(JCFG, params, jnp.asarray(tokens)))
    got = ttr.transformer_forward(TCFG, _port_params(), torch.from_numpy(tokens))
    assert got.shape == (B, T, KW["vocab"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_sp_forward_matches():
    params, tokens = _weights()
    mesh = _mesh("sp")
    want = np.asarray(jax.jit(jax.shard_map(
        lambda pp, tt: jtr.transformer_forward(JCFG, pp, tt, sp_axis="sp"),
        mesh=mesh, in_specs=(jtr.transformer_param_specs(JCFG, None),
                             P(None, "sp")),
        out_specs=P(None, "sp")))(params, jnp.asarray(tokens)))
    stacked = torch.from_numpy(tokens.reshape(B, N, T // N).transpose(1, 0, 2)
                               .copy())
    got = ttr.transformer_forward(TCFG, _port_params(), stacked, sp_axis="sp")
    assert got.shape == (N, B, T // N, KW["vocab"])
    np.testing.assert_allclose(got.numpy().transpose(1, 0, 2, 3)
                               .reshape(B, T, -1), want, rtol=0, atol=1e-4)


def test_tp_forward_matches():
    params, tokens = _weights()
    mesh = _mesh("tp")
    want = np.asarray(jax.jit(jax.shard_map(
        lambda pp, tt: jtr.transformer_forward(JCFG, pp, tt, tp_axis="tp"),
        mesh=mesh, in_specs=(jtr.transformer_param_specs(JCFG, "tp"), P()),
        out_specs=P(), check_vma=False))(params, jnp.asarray(tokens)))
    shards = ttr.shard_params(_port_params(), TCFG, N)
    got = ttr.transformer_forward(TCFG, shards, torch.from_numpy(tokens),
                                  tp_axis="tp")
    assert got.shape == (N, B, T, KW["vocab"])
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(), want, rtol=0, atol=1e-4)


def test_shard_params_cut_as_the_partition_specs_do():
    params = _port_params()
    shards = ttr.shard_params(params, TCFG, N)
    layer, cut = params["layers"][0], shards["layers"][0]
    d, f = KW["d_model"], KW["d_ff"]
    assert cut["w_qkv"].shape == (N, d, 3 * d // N)         # P(None, tp)
    assert cut["w_out"].shape == (N, f // N, d)             # P(tp, None)
    assert torch.equal(cut["w_qkv"][1], layer["w_qkv"][:, 24:48])
    assert torch.equal(cut["w_proj"][2], layer["w_proj"][16:24])
    assert cut["ln1"] is layer["ln1"] and shards["embed"] is params["embed"]
    specs = ttr.transformer_param_specs(TCFG, "tp")
    jspecs = jtr.transformer_param_specs(JCFG, "tp")
    for name in ("w_qkv", "w_proj", "w_in", "w_out", "ln1"):
        assert specs["layers"][0][name] == tuple(jspecs["layers"][0][name])
    with pytest.raises(ValueError):
        ttr.shard_params(params, TCFG, 5)


def test_init_shapes_scales_and_seed():
    g = torch.Generator().manual_seed(1)
    params = ttr.transformer_init(g, TCFG, device="cpu")
    jparams = jtr.transformer_init(jax.random.PRNGKey(1), JCFG)
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(params["layers"]) == KW["n_layers"]
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
    # the same scales: std of embed ~ d**-0.5, of w_proj ~ (2 d L)**-0.5
    assert abs(params["embed"].std().item() * KW["d_model"] ** 0.5 - 1) < 0.1
    assert torch.equal(params["ln_f"], torch.ones(KW["d_model"]))
    again = ttr.transformer_init(torch.Generator().manual_seed(1), TCFG, "cpu")
    assert torch.equal(again["layers"][1]["w_in"], params["layers"][1]["w_in"])


def test_init_goes_to_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttr.transformer_init(torch.Generator().manual_seed(1), TCFG)
    params = ttr.transformer_init(torch.Generator().manual_seed(1), TCFG,
                                  device=torch.device("cpu"))
    assert params["embed"].device.type == "cpu"


def test_flagship_parameter_count():
    # benchmarks/flagship_probe.py's configuration, counted, not allocated
    cfg = ttr.TransformerConfig(vocab=32768, d_model=1024, n_heads=16,
                                n_layers=8, d_ff=4096, dtype=torch.bfloat16)
    d, f = cfg.d_model, cfg.d_ff
    per_layer = 2 * d + 3 * d * d + d * d + 2 * d * f
    total = cfg.vocab * d + d + cfg.n_layers * per_layer
    assert cfg.head_dim == 64 and 134_000_000 < total < 135_000_000
