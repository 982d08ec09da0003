"""The port's training path (the f/g pair and ring attention under
autograd, the transformer and MLP train steps) against the JAX package on
the conftest's 8-device CPU mesh.

The same numpy inputs and the JAX model's own initial weights go through
both. The JAX side runs its functions under ``shard_map`` with
``check_vma=False``: the typing mode in which the JAX package's f/g pair
and its psum of each gradient leaf compute what its code states (the
psum over (dp, sp) of each rank's gradient, tp gradients whole from f/g).
Under JAX's default varying-axes typing, shard_map's own transpose already
sums the gradient of a replicated parameter over the ranks, so the JAX
steps' explicit psum/pmean counts it again: ``mlp_train_step_dp`` and the
dp/sp transformer steps then step with n times the gradient (checked here
as the port at n times the learning rate), and the tp step's gradients
are no multiple of the dense ones (ROADMAP Queue C).

Tolerances, float32: atol 1e-5 for gradients of one call; parameters
after 5 (transformer) or 40 (MLP) SGD steps atol 1e-5; losses atol 1e-5.
The two libraries sum in other orders and the port's attention follows
the Pallas kernel's rounding (-inf masks, float32-scaled scores), so
nothing here is bitwise.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from tpu_mpi import parallel as jpar
from tpu_mpi import xla as jxla
from tpu_mpi.models import mlp as jmlp
from tpu_mpi.models import transformer as jtr
from tpu_mpi_torch import parallel as tpar
from tpu_mpi_torch import xla as txla
from tpu_mpi_torch.kernels import fused_reduce as fr
from tpu_mpi_torch.models import mlp as tmlp
from tpu_mpi_torch.models import transformer as ttr

KW = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
JCFG = jtr.TransformerConfig(**KW)
TCFG = ttr.TransformerConfig(**KW)
B, T, N = 4, 32, 4
LR = 1e-2
STEPS = 5
ATOL = 1e-5
CPU = torch.device("cpu")
AXES = ("dp", "tp", "sp")


def _mesh(axes: dict):
    if len(jax.devices()) < int(np.prod(list(axes.values()))):
        pytest.skip("needs more devices")
    return jxla.make_mesh(axes)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# f / g
# ---------------------------------------------------------------------------

def test_f_g_grads_match_jax():
    rng = np.random.default_rng(70)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w1 = rng.standard_normal((16, 32)).astype(np.float32)
    w2 = rng.standard_normal((32, 16)).astype(np.float32)
    c = rng.standard_normal((8, 16)).astype(np.float32)
    mesh = _mesh({"tp": N})

    def local(x, w1, w2, c):
        def loss(x, w1, w2):
            h = jpar.column_parallel(x, w1, axis="tp")
            return (jpar.row_parallel(jnp.tanh(h), w2, axis="tp") * c).sum()
        return jax.grad(loss, argnums=(0, 1, 2))(x, w1, w2)

    want = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(None, "tp"), P("tp", None), P()),
        out_specs=(P(), P(None, "tp"), P("tp", None)), check_vma=False))(
            x, w1, w2, c)
    xt = torch.from_numpy(x).requires_grad_()
    w1s = torch.from_numpy(w1.reshape(16, N, 8).transpose(1, 0, 2).copy()
                           ).requires_grad_()
    w2s = torch.from_numpy(w2.reshape(N, 8, 16).copy()).requires_grad_()
    y = tpar.row_parallel(torch.tanh(tpar.column_parallel(xt, w1s)), w2s)
    (y * torch.from_numpy(c)).sum().backward()
    got = (xt.grad.numpy(), w1s.grad.numpy().transpose(1, 0, 2).reshape(16, 32),
           w2s.grad.numpy().reshape(32, 16))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)


def test_f_and_g_fold_in_rank_order_both_ways():
    xs = torch.randn(N, 5, dtype=torch.float64, requires_grad=True)
    y = tpar.tp_psum_fwd_identity_bwd(xs)
    assert y.shape == (5,) and torch.equal(y, ((xs[0] + xs[1]) + xs[2]) + xs[3])
    y.backward(torch.arange(5.0, dtype=torch.float64))
    assert torch.equal(xs.grad, torch.arange(5.0, dtype=torch.float64).expand(N, 5))
    x = torch.randn(5, dtype=torch.float64, requires_grad=True)
    rep = tpar.tp_identity_fwd_psum_bwd(x, n=N)
    assert rep.shape == (N, 5) and rep.stride(0) == 0
    cot = torch.randn(N, 5, dtype=torch.float64)
    rep.backward(cot)
    assert torch.equal(x.grad, ((cot[0] + cot[1]) + cot[2]) + cot[3])


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def _shard_seq(x: np.ndarray, n: int) -> torch.Tensor:
    b, h, t, d = x.shape
    return torch.from_numpy(x.reshape(b, h, n, t // n, d).transpose(2, 0, 1, 3, 4)
                            .copy())


def _unshard_seq(xs: torch.Tensor) -> np.ndarray:
    n, b, h, t, d = xs.shape
    return xs.numpy().transpose(1, 2, 0, 3, 4).reshape(b, h, n * t, d)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_grads_match_jax(n, causal):
    rng = np.random.default_rng(80 + n)
    q, k, v, c = (rng.standard_normal((2, 2, 32, 8)).astype(np.float32)
                  for _ in range(4))
    mesh = _mesh({"sp": n})
    ring = jax.shard_map(
        lambda a, b_, c_: jpar.ring_attention(a, b_, c_, axis="sp", causal=causal),
        mesh=mesh, in_specs=(P(None, None, "sp"),) * 3,
        out_specs=P(None, None, "sp"))
    want = jax.jit(jax.grad(lambda a, b_, c_: (ring(a, b_, c_) * c).sum(),
                            argnums=(0, 1, 2)))(q, k, v)
    qs, ks, vs = (_shard_seq(a, n).requires_grad_() for a in (q, k, v))
    out = tpar.ring_attention(qs, ks, vs, axis="sp", causal=causal)
    (out * _shard_seq(c, n)).sum().backward()
    for got, w in zip((qs.grad, ks.grad, vs.grad), want):
        assert got.shape == (n, 2, 2, 32 // n, 8)
        np.testing.assert_allclose(_unshard_seq(got), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_ring_attention_grads_come_back_in_the_callers_layout():
    # the model hands ring attention strided views of its qkv projection
    qkv = torch.randn(N, 2, 8, 2, 3, 4, requires_grad=True)    # (n,b,t,h,3,dh)
    q, k, v = (qkv.transpose(2, 3)[..., i, :] for i in range(3))
    assert not q.is_contiguous()
    tpar.ring_attention(q, k, v).square().sum().backward()
    assert qkv.grad.shape == qkv.shape and bool(qkv.grad.abs().sum() > 0)


# ---------------------------------------------------------------------------
# the transformer train step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup():
    params = jtr.transformer_init(jax.random.PRNGKey(0), JCFG)
    tokens = np.random.default_rng(20261016).integers(0, KW["vocab"], (B, T)) \
        .astype(np.int32)
    return params, tokens, np.roll(tokens, -1, axis=1)


def _jax_step(mesh, lr):
    """The JAX package's train step body (transformer_train_step's
    local_step, from its own functions) under shard_map without vma."""
    specs = jtr.transformer_param_specs(JCFG, "tp")

    def local_step(params, tokens, labels):
        def loss_fn(p):
            return jtr._xent(jtr.transformer_forward(
                JCFG, p, tokens, tp_axis="tp", sp_axis="sp"), labels)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.tree_util.tree_map(lambda g: lax.psum(g, ("dp", "sp")), grads)
        params = jax.tree_util.tree_map(lambda p, g: (p - lr * g).astype(p.dtype),
                                        params, grads)
        return params, lax.pmean(loss, ("dp", "sp"))

    return jax.jit(jax.shard_map(local_step, mesh=mesh,
                                 in_specs=(specs, P("dp", "sp"), P("dp", "sp")),
                                 out_specs=(specs, P()), check_vma=False))


def _jax_run(axis, step_of_mesh):
    params, tokens, labels = _setup()
    mesh = _mesh({a: (N if a == axis else 1) for a in AXES})
    step = step_of_mesh(mesh)
    out = []
    for _ in range(STEPS):
        params, loss = step(params, tokens, labels)
        out.append((_to_np(params), float(loss)))
    return out


def _unshard(params: dict, axis: str) -> dict:
    """The port's params (tp shards under tp) in the JAX layout, as numpy."""
    specs = ttr.transformer_param_specs(TCFG, "tp" if axis == "tp" else None)

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


def _port_run(axis, lr):
    jparams, tokens, labels = _setup()
    params = ttr.params_from_jax(_to_np(jparams), TCFG, CPU)
    if axis == "tp":
        params = ttr.shard_params(params, TCFG, N)
    step, _ = ttr.transformer_train_step(
        TCFG, txla.make_mesh({axis: N}, devices=[CPU]), lr=lr)
    toks, labs = torch.from_numpy(tokens), torch.from_numpy(labels)
    out = []
    for _ in range(STEPS):
        params, loss = step(params, toks, labs)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        out.append((_unshard(params, axis), float(loss)))
    return out


def _assert_runs_match(got, want):
    for s, ((gp, gl), (wp, wl)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= ATOL, (s, gl, wl)
        flat_g = jax.tree_util.tree_leaves(gp)
        flat_w = jax.tree_util.tree_leaves(wp)
        assert len(flat_g) == len(flat_w) == 2 + 6 * KW["n_layers"]
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"step {s}")
    # the loss falls, as in tests/test_parallel.py's own train-step check
    assert got[-1][1] < got[0][1]


@pytest.mark.parametrize("axis", ["sp", "tp", "dp"])
def test_train_step_matches_jax(axis):
    want = _jax_run(axis, lambda mesh: _jax_step(mesh, LR))
    _assert_runs_match(_port_run(axis, LR), want)


@pytest.mark.parametrize("axis", ["sp", "dp"])
def test_train_step_matches_jax_transformer_train_step_at_n_times_lr(axis):
    # JAX's own transformer_train_step (default vma typing) sums each
    # dp/sp gradient twice: it steps as the port does at n times the rate
    want = _jax_run(axis, lambda mesh: jtr.transformer_train_step(JCFG, mesh,
                                                                  lr=LR)[0])
    _assert_runs_match(_port_run(axis, N * LR), want)


@pytest.mark.parametrize("axis,folds", [
    ("sp", 2 + 6 * KW["n_layers"] + 1),      # a psum per parameter, the loss's
    ("dp", 2 + 6 * KW["n_layers"] + 1),
    ("tp", 4 * KW["n_layers"]),              # g forward, f backward
])
def test_train_step_folds_once_per_tensor(axis, folds, monkeypatch):
    calls = []
    plain = fr.fused_multi_reduce_plain
    monkeypatch.setattr(fr, "fused_multi_reduce_plain",
                        lambda xs, op: calls.append(len(xs)) or plain(xs, op))
    jparams, tokens, labels = _setup()
    params = ttr.params_from_jax(_to_np(jparams), TCFG, CPU)
    if axis == "tp":
        params = ttr.shard_params(params, TCFG, N)
    step, specs = ttr.transformer_train_step(
        TCFG, txla.make_mesh({axis: N}, devices=[CPU]))
    new, _ = step(params, torch.from_numpy(tokens), torch.from_numpy(labels))
    assert calls == [N] * folds
    assert specs == ttr.transformer_param_specs(TCFG, "tp")
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(tpar.dp.leaves(new), tpar.dp.leaves(params)))


def test_train_step_mesh_axes():
    with pytest.raises(ValueError, match="name none"):
        ttr.transformer_train_step(TCFG, txla.make_mesh({"x": N}, devices=[CPU]))
    with pytest.raises(ValueError, match="twice"):
        ttr.transformer_train_step(TCFG, txla.make_mesh({"x": N}, devices=[CPU]),
                                   dp_axis="x", sp_axis="x")
    # two live axes build a step (tests/test_torch_train_multi.py holds it
    # against the JAX step)
    jparams, tokens, labels = _setup()
    step, _ = ttr.transformer_train_step(
        TCFG, txla.make_mesh({"dp": 2, "sp": 2}, devices=[CPU]))
    new, loss = step(ttr.params_from_jax(_to_np(jparams), TCFG, CPU),
                     torch.from_numpy(tokens), torch.from_numpy(labels))
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    assert new["layers"][1]["w_out"].shape == (KW["d_ff"], KW["d_model"])


# ---------------------------------------------------------------------------
# the data-parallel MLP (tests/test_parallel.py::test_dp_mlp_end_to_end)
# ---------------------------------------------------------------------------

MLP_STEPS, MLP_N = 40, 8


@functools.lru_cache(maxsize=None)
def _mlp_setup():
    key = jax.random.PRNGKey(0)
    params = jmlp.mlp_init(key, [4, 16, 1])
    # float32 on both sides (the conftest may enable jax's x64)
    x = np.asarray(jax.random.normal(key, (64, 4)), dtype=np.float32)
    y = (x.sum(axis=1, keepdims=True) > 0).astype(np.float32)
    return params, x, y


def _mlp_runs(lr_jax, lr_port, vma):
    params, x, y = _mlp_setup()
    mesh = _mesh({"dp": MLP_N})
    rep = jax.tree_util.tree_map(lambda _: P(), params)
    step = jax.jit(jax.shard_map(
        lambda p, xx, yy: jmlp.mlp_train_step_dp(p, xx, yy, lr=lr_jax, axis="dp"),
        mesh=mesh, in_specs=(rep, P("dp"), P("dp")), out_specs=(rep, P()),
        check_vma=vma))
    tparams = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
               for layer in params]
    xs = torch.from_numpy(x.reshape(MLP_N, -1, 4))
    ys = torch.from_numpy(y.reshape(MLP_N, -1, 1))
    jp, tp_, losses = params, tparams, []
    for _ in range(MLP_STEPS):
        jp, jloss = step(jp, x, y)
        tp_, tloss = tmlp.mlp_train_step_dp(tp_, xs, ys, lr=lr_port, axis="dp")
        assert abs(float(tloss) - float(jloss)) <= ATOL
        for jl, tl in zip(jp, tp_):
            for k in ("w", "b"):
                np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                           rtol=0, atol=ATOL)
        losses.append(float(tloss))
    assert losses[-1] < losses[0] * 0.8


def test_mlp_train_step_dp_matches_jax():
    _mlp_runs(0.01, 0.01, vma=False)


def test_mlp_train_step_dp_matches_jax_default_typing_at_n_times_lr():
    _mlp_runs(0.01, 0.01 * MLP_N, vma=True)


def test_mlp_init_shapes_and_device(monkeypatch):
    params = tmlp.mlp_init(torch.Generator().manual_seed(0), [4, 16, 1], device="cpu")
    assert [tuple(layer["w"].shape) for layer in params] == [(4, 16), (16, 1)]
    assert torch.equal(params[1]["b"], torch.zeros(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match='device="cpu"'):
        tmlp.mlp_init(torch.Generator().manual_seed(0), [4, 1])
