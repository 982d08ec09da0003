"""The port's inference engine (``tpu_mpi_torch.infer``) against the JAX
package's.

``tests/test_infer.py`` rebuilt against the port
(``test_torch_refport.port_module``; brokers and KV caches on
``device="cpu"``), each test under its reference name: the paged KV
cache, continuous batching over the serve broker, SLO eviction,
mid-stream revocation, the KV-stream overlap and the decode fast path's
bitwise identity matrix. Also:

- the JAX engine's parameters, carried across as numpy (``params=``),
  through a JAX broker and the port's ``device="cpu"`` broker on the same
  prompts: greedy streams equal and every sampled step's final-row logits
  within ``LOGIT_ATOL`` (the port's reductions sum in another order than
  numpy's, so logits agree to rounding, not bitwise); the smallest
  top-1/top-2 margin seen is printed, the room the streams had;
- ``PagedKVCache`` against the reference's numpy cache over one seeded
  history of appends, truncations, prefix registrations and adoptions,
  copy-on-write forks and closes: every view bitwise, every stats dict
  equal;
- the tensor route of ``parallel.ep.moe_host_dispatch_combine`` against
  the reference's numpy route on 4 ranks, bitwise (an exact expert).
"""

import numpy as np
import pytest
import torch

from test_torch_refport import adopt, port_module

adopt(globals(), port_module("test_infer"))

LOGIT_ATOL = 1e-4
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6], list(range(20, 34)),
           [40, 41], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]]


def _jax_params(cfg, seed, n_experts):
    import jax
    from tpu_mpi.models.transformer import transformer_pp_moe_init
    params = transformer_pp_moe_init(jax.random.PRNGKey(seed), cfg, n_experts)
    return {k: np.asarray(v) for k, v in params.items()}


def _streams(pkg, nranks, spec, prompts):
    """Greedy streams of ``prompts`` (one at a time) through one package's
    broker, and the final-row logits of every sampled token in order."""
    import importlib
    serve = importlib.import_module(pkg + ".serve")
    kw = {"device": "cpu"} if pkg == "tpu_mpi_torch" else {}
    b = serve.Broker(nranks=nranks, token="tk", infer=spec, **kw)
    b.run_in_thread()
    logits = []
    eng = b.infer_engine
    if pkg == "tpu_mpi_torch":
        eng.logit_log = {}
    else:
        # the JAX engine's own sampling, with its final-row logits kept
        from tpu_mpi.infer import engine as jeng
        sample = eng._sample

        def logged(st, x):
            logits.append(jeng._rms_row(x, st["sp"]["ln_f"])
                          @ st["sp"]["embed"].T)
            return sample(st, x)
        eng._sample = logged
    try:
        with serve.attach(b.address, tenant="par", token="tk") as s:
            outs = [s.generate(p, max_new=12) for p in prompts]
    finally:
        b.close()
    if pkg == "tpu_mpi_torch":
        logits = [row for rid in sorted(eng.logit_log)
                  for row in eng.logit_log[rid]]
    return outs, np.stack(logits)


@pytest.mark.parametrize("spec", [{}, {"vectorized": False},
                                  {"spec_k": 4, "prefix_share": True}],
                         ids=["vectorized", "row_loop", "spec_prefix"])
def test_engine_streams_and_logits_match_the_jax_engine(spec):
    from tpu_mpi.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                            d_ff=64, max_seq=128)
    want, want_logits = _streams("tpu_mpi", 4, dict(spec) or True, PROMPTS)
    got, got_logits = _streams(
        "tpu_mpi_torch", 4, {**spec, "params": _jax_params(cfg, 0, 2)},
        PROMPTS)
    assert got == want
    if spec.get("spec_k", 1) == 1:
        # one sampled row a token on both sides (a speculative step samples
        # its drafted rows too, in an order of its own)
        assert got_logits.shape == want_logits.shape
        err = np.abs(got_logits - want_logits).max()
        top2 = np.sort(want_logits, axis=1)[:, -2:]
        print(f"max |logit diff| {err:.3g}, smallest top-1/top-2 margin "
              f"{(top2[:, 1] - top2[:, 0]).min():.3g}")
        assert err <= LOGIT_ATOL


def test_engine_default_params_are_seeded_and_device_resident():
    from tpu_mpi_torch import serve
    outs = []
    for _ in range(2):
        b = serve.Broker(nranks=2, token="tk", infer={"seed": 7},
                         device="cpu")
        b.run_in_thread()
        try:
            eng = b.infer_engine
            for st in eng._state.values():
                assert all(t.device.type == "cpu" for t in st["sp"].values())
                assert st["kv"].k.device.type == "cpu"
            mem = eng.memory_bytes()
            assert all(m["weights"] > 0 and m["kv"] > 0 for m in mem.values())
            with serve.attach(b.address, tenant="s", token="tk") as s:
                outs.append(s.generate([5, 6, 7], max_new=6))
        finally:
            b.close()
    assert outs[0] == outs[1]


def _kv_history(mod, make_rows):
    """One seeded history of cache operations through one package's
    ``PagedKVCache``: every view and stats dict along the way."""
    rng = np.random.default_rng(3)
    kv = mod.PagedKVCache(12, 4, 2, 3, **({"device": "cpu"}
                                          if "torch" in mod.__name__ else {}))
    seen = []

    def look(sid, layers=(0, 1)):
        for li in layers:
            k, v = kv.view(sid, li)
            seen.append((np.asarray(k).tobytes(), np.asarray(v).tobytes(),
                         kv.length(sid, li)))
        seen.append(sorted(kv.stats().items()))

    toks = [int(t) for t in rng.integers(0, 50, 10)]
    for t in toks:
        for li in (0, 1):
            k, v = rng.standard_normal((2, 2, 3)).astype(np.float32)
            kv.append(1, li, make_rows(k), make_rows(v))
    look(1)
    kv.register_prefix(1, toks)
    seen.append(kv.prefix_acquire(2, toks))
    look(2)
    for li in (0, 1):
        kv.append(2, li, make_rows(np.full((2, 3), 7.0, np.float32)),
                  make_rows(np.full((2, 3), -7.0, np.float32)))
    look(2)
    look(1)
    kv.truncate(2, 5)
    look(2)
    seen.append(kv.prefix_acquire(3, toks[:6] + [99, 98]))
    look(3)
    seen.append(kv.close(1))
    seen.append(kv.close(2))
    look(3)
    seen.append(kv.free_blocks())
    return seen


def test_paged_kvcache_matches_the_reference_cache():
    from tpu_mpi.infer import kvcache as ref
    from tpu_mpi_torch.infer import kvcache as port
    want = _kv_history(ref, lambda a: a)
    got = _kv_history(port, torch.from_numpy)
    assert got == want


def test_moe_dispatch_tensor_route_matches_the_numpy_route():
    import tpu_mpi
    import tpu_mpi_torch
    from tpu_mpi.parallel import ep as ref_ep
    from tpu_mpi_torch.parallel import ep as port_ep
    rng = np.random.default_rng(9)
    n, d = 4, 5
    toks = [rng.standard_normal((int(k), d)).astype(np.float32)
            for k in rng.integers(0, 7, n)]
    idx = [rng.integers(0, n, t.shape[0]) for t in toks]

    def body(M, ep, wrap, unwrap):
        def run():
            r = M.Comm_rank(M.COMM_WORLD)
            comm = M.Comm_dup(M.COMM_WORLD)

            def expert(rows):                 # exact: data movement only
                return rows * 2 + r
            return [unwrap(ep.moe_host_dispatch_combine(
                wrap(toks[r]), idx[r], expert, comm, capacity=cap))
                for cap in (2, 8)]
        return run

    want = tpu_mpi.spmd_run(body(tpu_mpi, ref_ep, lambda a: a, np.asarray), n)
    got = tpu_mpi_torch.spmd_run(
        body(tpu_mpi_torch, port_ep, torch.from_numpy,
             lambda t: t.numpy()), n)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
