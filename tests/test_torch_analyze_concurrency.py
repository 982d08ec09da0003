"""The static concurrency lint and the runtime lock witness of the port
(``tpu_mpi_torch.analyze.concurrency``, ``tpu_mpi_torch.locksmith``).

``tests/test_concurrency.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name:
the lock lint over the corpus rewritten for the port (``port_corpus``),
the whole ``tpu_mpi_torch`` tree and ``examples/`` clean, the port
broker's lock edges discovered, and the witness (``TPU_MPI_LOCKCHECK``),
its contention pvars and T215 at run time; its serve cases run the
port's broker on ``device="cpu"``, and its chaos case runs the port's
serve tests. Beside it: the lock lint gives the JAX package's diagnostics
on every corpus file, and the two brokers give the same lock edges.
"""

import os

import pytest

from tpu_mpi.analyze import concurrency as jconc
from tpu_mpi_torch.analyze import concurrency as pconc

from test_torch_refport import CORPUS, adopt, corpus_subs, port_corpus, \
    port_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = port_module("test_concurrency", subs=corpus_subs() + (
    (r'"test_serve\.py"', '"test_torch_serve.py"'),))
adopt(globals(), _REF)

_FILES = sorted(f for f in os.listdir(CORPUS) if f.endswith(".py"))


def _view(diags):
    """Diagnostics with the corpus directory named alike in both."""
    def here(text):
        return text.replace(port_corpus(), "CORPUS").replace(CORPUS, "CORPUS")
    return [(d.code, os.path.basename(d.file), d.line, here(d.message),
             tuple((os.path.basename(f), ln, here(note))
                   for f, ln, note in d.related))
            for d in diags]


@pytest.mark.parametrize("name", _FILES)
def test_lock_lint_equals_jax_on_corpus(name):
    got = pconc.lock_lint_paths([os.path.join(port_corpus(), name)])
    want = jconc.lock_lint_paths([os.path.join(CORPUS, name)])
    assert _view(got) == _view(want)


def _edges(conc, pkg):
    path = os.path.join(REPO, pkg, "serve", "broker.py")
    with open(path) as f:
        an, diags = conc._analyze_source(f.read(), path)
    assert diags == []
    return {(a.split(".")[-1], b.split(".")[-1]) for a, b in an.edges}


def test_broker_lock_edges_equal_jax():
    got = _edges(pconc, "tpu_mpi_torch")
    assert got == _edges(jconc, "tpu_mpi")
    assert {("_dispatch_lock", "_queues_lock"),
            ("_dispatch_lock", "_links_lock")} <= got


def test_rebuilt_concurrency_reads_the_port():
    src = _REF._port_source
    assert f"CORPUS = {port_corpus()!r}" in src
    assert 'os.path.join(REPO, "tpu_mpi_torch", "serve", "broker.py")' in src
    assert '"test_torch_serve.py"' in src
    assert _REF.conc is pconc
