"""``tests/test_elastic.py`` rebuilt against the port's elastic tier
(``test_torch_refport.port_module``; brokers on ``device="cpu"``), each
test under its reference name: fair-queue pause/resume, the typed
degraded-pool error, degraded serving, the restore resize (shrink, grow,
rebind) with zero dropped tenants, the rebind edges (attach parked on the
resize gate, revocation racing a rebind, an SLO eviction straddling a
resize with the inference engine live) and the controller's pressure grow
and idle retire. Also: a generation spanning a restore resize streams the
same tokens as the same request on an undisturbed broker, and the
engine's shard and KV tensors move with their slot without a copy.
"""

import threading
import time

import numpy as np

from tpu_mpi_torch import config, serve

from test_torch_refport import adopt, port_module

adopt(globals(), port_module("test_elastic"))

TOKEN = "tk"


def _env(monkeypatch, **kw):
    for k, v in {"INTERVAL_MS": "3600000", "COOLDOWN_MS": "0", **kw}.items():
        monkeypatch.setenv(f"TPU_MPI_ELASTIC_{k}", str(v))
    config.load(refresh=True)


def _generate(b, prompt, max_new, tenant):
    with serve.attach(b.address, tenant=tenant, token=TOKEN) as s:
        return s.generate(prompt, max_new=max_new)


def test_generation_spanning_a_restore_resize_streams_undisturbed(
        monkeypatch):
    """Rank 3 (a stage-1 rank of the engine) is declared dead while a
    long generation streams; the controller shrinks it out, grows a
    replacement and rebinds the engine onto it. The stream is the one an
    undisturbed broker gives for the same prompt, a tenant folding on the
    pool keeps bitwise replies, and the engine's tensors moved with the
    slot (the same storage, on the replacement rank).

    The verdict lands at a step boundary (the scheduler parked, as the
    resize itself parks it): a verdict landing during an engine step fails
    that step's collectives, which takes the engine down for good, in the
    reference as here (ROADMAP Queue C)."""
    prompt, max_new = list(range(3, 17)), 40
    _env(monkeypatch)
    try:
        calm = serve.Broker(nranks=4, token=TOKEN, infer=True, device="cpu")
        calm.run_in_thread()
        try:
            want = _generate(calm, prompt, max_new, "calm")
        finally:
            calm.close()
        b = serve.Broker(nranks=4, token=TOKEN, infer=True, elastic=True,
                         device="cpu")
        b.run_in_thread()
        try:
            eng = b.infer_engine
            before = {k: v.data_ptr() for k, v in eng._state[3]["sp"].items()}
            kv_before = eng._state[3]["kv"].k.data_ptr()
            out, streamed = {}, []
            started = threading.Event()

            def on_token(t):
                streamed.append(t)
                if len(streamed) >= 4:
                    started.set()

            def gen():
                with serve.attach(b.address, tenant="rider",
                                  token=TOKEN) as s:
                    out["toks"] = s.generate(prompt, max_new=max_new,
                                             on_token=on_token)

            th = threading.Thread(target=gen)
            th.start()
            with serve.attach(b.address, tenant="folds", token=TOKEN,
                              nranks=2) as s:
                parts = [np.arange(6, dtype=np.float32) * (i + 1)
                         for i in range(2)]
                first = s.allreduce(parts)
                assert started.wait(60)
                assert b._infer_sched.pause(timeout=30)
                b.on_rank_failure(3)          # the resize resumes the engine
                assert s.allreduce(parts).tobytes() == first.tobytes()
                deadline = time.monotonic() + 60
                while (b.elastic_state["resizes"] < 1
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
                assert b.elastic_state["resizes"] == 1, b.elastic_state
                assert s.allreduce(parts).tobytes() == first.tobytes()
            th.join(timeout=120)
            assert out["toks"] == want and streamed == want
            assert 3 not in eng.ranks and len(eng.ranks) == 4
            new = eng.ranks[3]
            assert {k: v.data_ptr() for k, v in
                    eng._state[new]["sp"].items()} == before
            assert eng._state[new]["kv"].k.data_ptr() == kv_before
            assert _generate(b, prompt, max_new, "after") == want
        finally:
            b.close()
    finally:
        config.load(refresh=True)
