"""The port's train steps over meshes of several axes — dp x tp x sp, the
pipelined MoE (dp x pp x ep) and the 4-axis step (dp x tp x sp x pp) —
against the JAX package on the conftest's 8-device CPU mesh.

The same numpy tokens and the JAX model's own initial weights go through
both. The JAX side is the JAX package's own step, built while
``jax.shard_map`` is wrapped to pass ``check_vma=False``: the typing mode
in which its psums compute what its code states (ROADMAP Queue C; under
the default typing the pp x moe step takes 4x the novma update of
``embed``/``ln_f``, 2x of the layer tensors and 1x of the experts, and the
4-axis step with a live tp axis no multiple at all, measured here).

Tolerances, float32: atol 1e-5 for parameters after several SGD steps and
for losses, as ``tests/test_torch_train_step.py`` states: the two
libraries sum in other orders, and the port's ring attention follows the
Pallas kernel's rounding, so nothing here is bitwise. 4-axis meshes of
four live axes need 16 ranks, more than the CPU mesh's 8 devices: the
port alone runs ``dp2 x tp2 x sp2 x pp2`` against the dense autograd step
at ``n_pp`` times the loss (the psum of the last stage's loss over pp,
transposed as a psum, seeds the last stage with n_pp).
"""

import contextlib
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from tpu_mpi import xla as jxla
from tpu_mpi.models import transformer as jtr
from tpu_mpi_torch import xla as txla
from tpu_mpi_torch.kernels import fused_reduce as fr
from tpu_mpi_torch.models import transformer as ttr
from tpu_mpi_torch.kernels._build import counts

KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
JCFG = jtr.TransformerConfig(**KW)
TCFG = ttr.TransformerConfig(**KW)
LR = 1e-2
STEPS = 3
ATOL = 1e-5
CPU = torch.device("cpu")


@contextlib.contextmanager
def _no_vma():
    """Build JAX steps under shard_map(..., check_vma=False)."""
    orig = jax.shard_map

    def smap(f, **kw):
        kw["check_vma"] = False
        return orig(f, **kw)

    jax.shard_map = smap
    try:
        yield
    finally:
        jax.shard_map = orig


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(b, t, seed):
    tok = np.random.default_rng(seed).integers(0, KW["vocab"], (b, t)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _jax_run(build, params, tok, lab, steps=STEPS):
    with _no_vma():
        step, _ = build()
    out = []
    for _ in range(steps):
        params, loss = step(params, tok, lab)
        out.append((_np(params), float(loss)))
    return out


def _port_run(step, params, tok, lab, unshard, steps=STEPS):
    toks, labs = torch.from_numpy(tok), torch.from_numpy(lab)
    out = []
    for _ in range(steps):
        params, loss = step(params, toks, labs)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        out.append((unshard(params), float(loss)))
    return out


def _assert_runs_match(got, want):
    for s, ((gp, gl), (wp, wl)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= ATOL, (s, gl, wl)
        flat_g, flat_w = jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(wp)
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"step {s}")
    assert got[-1][1] < got[0][1]


def _count_folds(monkeypatch):
    calls = []
    plain = fr.fused_multi_reduce_plain
    monkeypatch.setattr(fr, "fused_multi_reduce_plain",
                        lambda xs, op: calls.append(len(xs)) or plain(xs, op))
    return calls


# ---------------------------------------------------------------------------
# dp x tp x sp
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _flat_setup():
    return jtr.transformer_init(jax.random.PRNGKey(0), JCFG), *_tokens(4, 32, 9)


def _unshard_flat(params):
    specs = ttr.transformer_param_specs(TCFG, "tp")

    def join(x, spec):
        x = x.detach()
        if spec == (None, "tp"):
            return x.movedim(0, 1).reshape(x.shape[1], -1).numpy()
        if spec == ("tp", None):
            return x.reshape(-1, x.shape[-1]).numpy()
        return x.numpy()

    return {"embed": join(params["embed"], ()), "ln_f": join(params["ln_f"], ()),
            "layers": [{k: join(v, s[k]) for k, v in layer.items()}
                       for layer, s in zip(params["layers"], specs["layers"])]}


def _flat_port(axes):
    jparams, tok, lab = _flat_setup()
    params = ttr.shard_params(ttr.params_from_jax(_np(jparams), TCFG, CPU), TCFG,
                              axes["tp"])
    step, specs = ttr.transformer_train_step(TCFG, txla.make_mesh(axes, devices=[CPU]),
                                             lr=LR)
    return step, specs, params, tok, lab


@functools.lru_cache(maxsize=None)
def _flat_jax_run():
    jparams, tok, lab = _flat_setup()
    return _jax_run(lambda: jtr.transformer_train_step(
        JCFG, jxla.make_mesh({"dp": 2, "tp": 2, "sp": 2}), lr=LR), jparams, tok, lab)


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 2, "sp": 2},
                                  {"sp": 2, "dp": 2, "tp": 2}])
def test_dp_tp_sp_step_matches_jax(axes):
    # the JAX step's psums run over the tuple (dp, sp) whatever the mesh's
    # order, so one JAX run serves both of the port's layouts
    want = _flat_jax_run()
    step, specs, params, tok, lab = _flat_port(axes)
    _assert_runs_match(_port_run(step, params, tok, lab, _unshard_flat), want)
    assert specs == ttr.transformer_param_specs(TCFG, "tp")


def test_dp_tp_sp_step_folds_once_per_tensor(monkeypatch):
    calls = _count_folds(monkeypatch)
    step, _, params, tok, lab = _flat_port({"dp": 2, "tp": 2, "sp": 2})
    counts.reset()
    step(params, torch.from_numpy(tok), torch.from_numpy(lab))
    L = KW["n_layers"]
    # f/g: 4 a layer over the 2 tp ranks; a (dp, sp) psum of 4 ranks per
    # parameter tensor and for the loss
    assert sorted(calls) == [2] * (4 * L) + [4] * (2 + 6 * L + 1)
    # the tp-sharded gradients (n_tp, n_dp, n_sp, ...) bring (dp, sp) forward
    assert counts["layout_copies"] == 4 * L


def test_dp_tp_sp_forward_matches_jax():
    jparams, tok, _ = _flat_setup()
    mesh = jxla.make_mesh({"tp": 2, "sp": 4})
    want = np.asarray(jax.jit(jax.shard_map(
        lambda pp, tt: jtr.transformer_forward(JCFG, pp, tt, tp_axis="tp",
                                               sp_axis="sp"),
        mesh=mesh, in_specs=(jtr.transformer_param_specs(JCFG, "tp"), P(None, "sp")),
        out_specs=P(None, "sp"), check_vma=False))(jparams, jnp.asarray(tok)))
    params = ttr.shard_params(ttr.params_from_jax(_np(jparams), TCFG, CPU), TCFG, 2)
    b, t = tok.shape
    stacked = torch.from_numpy(tok.reshape(b, 4, t // 4).transpose(1, 0, 2).copy())
    got = ttr.transformer_forward(TCFG, params, stacked, tp_axis="tp", sp_axis="sp")
    assert got.shape == (2, 4, b, t // 4, KW["vocab"])
    for r in range(2):
        np.testing.assert_allclose(got[r].numpy().transpose(1, 0, 2, 3).reshape(b, t, -1),
                                   want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# pp x moe
# ---------------------------------------------------------------------------

MOE = {"dp": 2, "pp": 2, "ep": 2}


def _moe_params():
    return jtr.transformer_pp_moe_init(jax.random.PRNGKey(3), JCFG, 2)


@functools.lru_cache(maxsize=None)
def _moe_setup():
    return _moe_params(), *_tokens(8, 16, 11)


def _moe_port():
    jparams, tok, lab = _moe_setup()
    params = ttr.params_from_jax(_np(jparams), TCFG, CPU)
    step, specs = ttr.transformer_pp_moe_train_step(
        TCFG, txla.make_mesh(MOE, devices=[CPU]), 2, lr=LR)
    return step, specs, params, tok, lab


def _plain(params):
    return {k: v.detach().numpy() for k, v in params.items()}


def test_pp_moe_step_matches_jax():
    jparams, tok, lab = _moe_setup()
    want = _jax_run(lambda: jtr.transformer_pp_moe_train_step(
        JCFG, jxla.make_mesh(MOE), 2, lr=LR), jparams, tok, lab)
    step, specs, params, tok, lab = _moe_port()
    _assert_runs_match(_port_run(step, params, tok, lab, _plain), want)
    jspecs = jtr.transformer_pp_moe_specs("pp", "ep")
    assert specs == {k: tuple(v) for k, v in jspecs.items()}


def test_pp_moe_step_folds_once_per_psum(monkeypatch):
    calls = _count_folds(monkeypatch)
    step, _, params, tok, lab = _moe_port()
    step(params, torch.from_numpy(tok), torch.from_numpy(lab))
    # 5 layer tensors x psum(dp) and pmean(ep); embed/ln_f x psum((dp, pp))
    # and pmean(ep); the experts x psum(dp); the loss's pp psum and its
    # transpose; pmean(pmean(loss, dp), ep)
    assert sorted(calls) == sorted([2] * (5 * 2 + 2 + 2 + 4) + [4] * 2)


def test_pp_moe_host_params_match_jax():
    jparams, _, _ = _moe_setup()
    params = ttr.params_from_jax(_np(jparams), TCFG, CPU)
    for stage, expert in [(0, 1), (1, 0)]:
        got = ttr.transformer_pp_moe_host_params(params, TCFG, 2, stage, 2, expert)
        want = jtr.transformer_pp_moe_host_params(jparams, JCFG, 2, stage, 2, expert)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == np.float32 and got[k].flags.c_contiguous
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        ttr.transformer_pp_moe_host_params(params, TCFG, 2, 0, 2, 2)


def test_pp_moe_and_4d_init_shapes_follow_jax():
    g = torch.Generator().manual_seed(1)
    for port, jax_ in [
            (ttr.transformer_pp_moe_init(g, TCFG, 2, device="cpu"),
             _moe_params()),
            (ttr.transformer_4d_init(g, TCFG, device="cpu"),
             jtr.transformer_4d_init(jax.random.PRNGKey(1), JCFG))]:
        assert port.keys() == jax_.keys()
        for k in port:
            assert tuple(port[k].shape) == jax_[k].shape
    assert torch.equal(port["ln1"], torch.ones(KW["n_layers"], KW["d_model"]))
    specs = ttr.transformer_4d_specs("pp", "tp")
    assert specs == {k: tuple(v) for k, v in
                     jtr.transformer_4d_specs("pp", "tp").items()}


# ---------------------------------------------------------------------------
# 4-axis
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _4d_params():
    return jtr.transformer_4d_init(jax.random.PRNGKey(5), JCFG)


def _unshard_4d(params):
    specs = ttr.transformer_4d_specs("pp", "tp")

    def join(x, spec):
        x = x.detach()
        if spec and spec[-1] == "tp":
            return x.movedim(0, -2).flatten(-2).numpy()
        if len(spec) > 1 and spec[1] == "tp":
            return x.movedim(0, 1).flatten(1, 2).numpy()
        return x.numpy()

    return {k: join(v, specs[k]) for k, v in params.items()}


def _4d_port(axes, params_np):
    params = ttr.shard_params(ttr.params_from_jax(params_np, TCFG, CPU), TCFG,
                              axes["tp"])
    step, _ = ttr.transformer_4d_train_step(TCFG, txla.make_mesh(axes, devices=[CPU]),
                                            lr=LR)
    return step, params


@pytest.mark.parametrize("axes", [{"dp": 1, "tp": 2, "sp": 2, "pp": 2},
                                  {"dp": 2, "tp": 2, "sp": 2, "pp": 1},
                                  {"dp": 2, "tp": 1, "sp": 2, "pp": 2}])
def test_4d_step_matches_jax(axes):
    jparams = _4d_params()
    tok, lab = _tokens(4 * axes["dp"], 16, 13)
    want = _jax_run(lambda: jtr.transformer_4d_train_step(JCFG, jxla.make_mesh(axes),
                                                          lr=LR), jparams, tok, lab)
    step, params = _4d_port(axes, _np(jparams))
    _assert_runs_match(_port_run(step, params, tok, lab, _unshard_4d), want)


def _dense_4d_step(params_np, tok, lab, shards, lr, scale):
    """The dense autograd step the 4-axis step computes: each (dp, sp)
    block's loss the mean over its tokens, the blocks' losses summed and
    scaled by ``scale``, SGD; the loss the blocks' mean."""
    p = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in params_np.items()}
    flat = {"embed": p["embed"], "ln_f": p["ln_f"],
            "layers": [{k: p[k][i] for k in ("ln1", "w_qkv", "w_proj", "ln2",
                                              "w_in", "w_out")}
                       for i in range(KW["n_layers"])]}
    logits = ttr.transformer_forward(TCFG, flat, torch.from_numpy(tok))
    n_dp, n_sp = shards
    b, t = tok.shape[0] // n_dp, tok.shape[1] // n_sp
    labs = torch.from_numpy(lab)
    losses = [ttr._xent(logits[i * b:(i + 1) * b, j * t:(j + 1) * t],
                        labs[i * b:(i + 1) * b, j * t:(j + 1) * t])
              for i in range(n_dp) for j in range(n_sp)]
    total = sum(losses)
    grads = torch.autograd.grad(total * scale, list(p.values()))
    return ({k: (v - lr * g).detach().numpy() for (k, v), g in zip(p.items(), grads)},
            float(total.detach()) / len(losses))


def test_4d_step_of_four_live_axes_matches_the_dense_step(monkeypatch):
    axes = {"dp": 2, "tp": 2, "sp": 2, "pp": 2}
    params_np = _np(_4d_params())
    tok, lab = _tokens(8, 16, 17)
    calls = _count_folds(monkeypatch)
    step, params = _4d_port(axes, params_np)
    new, loss = step(params, torch.from_numpy(tok), torch.from_numpy(lab))
    want, want_loss = _dense_4d_step(params_np, tok, lab, (2, 2), LR, axes["pp"])
    got = _unshard_4d(new)
    assert abs(float(loss) - want_loss) <= ATOL
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)
    L_l, ticks = KW["n_layers"] // 2, 4 + 2 - 1
    # f/g: 4 a layer a tick; psums: embed/ln_f over (dp, sp, pp), 6 layer
    # stacks over (dp, sp); the loss's pp psum, its transpose, the (dp, sp) mean
    assert sorted(calls) == sorted([2] * (4 * L_l * ticks) + [8] * 2 + [4] * 6
                                   + [2, 2, 4])


def test_model_exports_follow_the_jax_package():
    from tpu_mpi_torch import models
    for name in ["transformer_pp_moe_init", "transformer_pp_moe_specs",
                 "transformer_pp_moe_host_params", "transformer_pp_moe_train_step",
                 "transformer_4d_init", "transformer_4d_specs",
                 "transformer_4d_train_step", "transformer_train_step",
                 "transformer_forward", "transformer_init", "TransformerConfig"]:
        assert callable(getattr(jtr, name)) and callable(getattr(models, name)), name
