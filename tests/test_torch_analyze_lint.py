"""The static communication lint of the port (``tpu_mpi_torch.analyze.lint``).

``tests/test_analyze_lint.py`` rebuilt against the port
(``test_torch_refport.port_module``), each test under its reference name,
over the corpus rewritten for the port (``port_corpus``: every marker on
its line); its whole-tree and parallel-package cases read
``tpu_mpi_torch/``. Beside it: the port's lint gives the JAX lint's
diagnostics on every corpus file (code, line, message, context, related),
and reads torch's buffer constructors as torch reads them.
"""

import ast
import os

import pytest

from tpu_mpi.analyze import lint as jlint
from tpu_mpi_torch.analyze import lint as plint

from test_torch_refport import CORPUS, adopt, corpus_subs, port_corpus, \
    port_module

_REF = port_module("test_analyze_lint", subs=corpus_subs())
adopt(globals(), _REF)

_FILES = sorted(f for f in os.listdir(CORPUS) if f.endswith(".py"))


def _view(diags):
    return [(d.code, os.path.basename(d.file), d.line, d.message, d.context,
             tuple((os.path.basename(f), ln, note) for f, ln, note in d.related))
            for d in diags]


def test_rebuilt_lint_reads_the_ported_corpus_and_tree():
    src = _REF._port_source
    assert f"CORPUS = {port_corpus()!r}" in src
    assert 'os.path.join(REPO, "tpu_mpi_torch")' in src
    assert 'os.path.join(REPO, "tpu_mpi_torch", "parallel")' in src
    assert _REF.alint is plint


@pytest.mark.parametrize("name", _FILES)
def test_lint_equals_jax_lint_on_corpus(name):
    """The same corpus file through both lints: the port's reads its
    rewritten copy, the JAX package's the original."""
    got = plint.lint_paths([os.path.join(port_corpus(), name)])
    want = jlint.lint_paths([os.path.join(CORPUS, name)])
    assert _view(got) == _view(want)


@pytest.mark.parametrize("name", _FILES)
def test_lint_source_equals_jax_on_the_original(name):
    path = os.path.join(CORPUS, name)
    with open(path) as f:
        src = f.read()
    got, want = plint.lint_source(src, path), jlint.lint_source(src, path)
    assert [d.__dict__ for d in got] == [d.__dict__ for d in want]


# -- torch's constructors ----------------------------------------------------

def _p2p(send_buf, recv_buf):
    return (
        "import numpy as np\n"
        "import torch\n"
        "import tpu_mpi_torch as MPI\n"
        "comm = MPI.COMM_WORLD\n"
        "rank = MPI.Comm_rank(comm)\n"
        "if rank == 0:\n"
        f"    buf = {send_buf}\n"
        "    MPI.Send(buf, 1, 0, comm)\n"
        "else:\n"
        f"    out = {recv_buf}\n"
        "    MPI.Recv(out, 0, 0, comm)\n")


def _l104(send_buf, recv_buf):
    return [(d.code, d.line, d.message)
            for d in plint.lint_source(_p2p(send_buf, recv_buf), "p2p.py")]


@pytest.mark.parametrize("send_buf,recv_buf", [
    ("torch.zeros(8, 1)", "torch.zeros(2, 4)"),          # varargs shapes
    ("torch.zeros((2, 4))", "torch.ones([4, 2])"),        # one sequence
    ("torch.empty(2, 2, 2)", "torch.zeros(size=(8,))"),
    ("torch.full((4, 2), 1.0)", "torch.zeros(8)"),
    ("torch.tensor([[1, 2], [3, 4]])", "torch.zeros(2, 2)"),
    ("torch.arange(2, 10)", "torch.zeros(8, dtype=torch.float32)"),
    ("torch.zeros(2, 4)", "np.zeros(8, np.float32)"),
])
def test_torch_shapes_of_equal_size_are_silent(send_buf, recv_buf):
    assert _l104(send_buf, recv_buf) == []


@pytest.mark.parametrize("send_buf,recv_buf,n_recv,n_send", [
    ("torch.zeros(2, 4)", "torch.zeros(2, 3)", 6, 8),
    ("torch.zeros((2, 4))", "torch.zeros([7])", 7, 8),
    ("torch.full((3, 3), 2.0)", "torch.empty(2, 4)", 8, 9),
    ("torch.tensor([1.0, 2.0, 3.0])", "torch.zeros(2)", 2, 3),
    ("torch.arange(0, 12, 3)", "torch.zeros(3)", 3, 4),
])
def test_torch_shape_mismatch_is_l104(send_buf, recv_buf, n_recv, n_send):
    assert _l104(send_buf, recv_buf) == [(
        "L104", 11, f"receive buffer holds {n_recv} elements but the "
        f"matching send (line 8, tag 0) ships {n_send}")]


def test_numpy_buffers_keep_numpy_reading():
    # numpy's second positional argument is the dtype, not a dimension
    assert _l104("np.zeros(8)", "np.zeros(8, np.float32)") == []
    assert [c for c, _, _ in _l104("np.zeros(8)", "np.zeros(4, np.float32)")] \
        == ["L104"]


def _dtypes(maker):
    src = ("import torch\n"
           "import tpu_mpi_torch as MPI\n"
           "comm = MPI.COMM_WORLD\n"
           "rank = MPI.Comm_rank(comm)\n"
           f"x = {maker}\n")
    return plint._Linter("d.py", ast.parse(src)).var_buf.get("x")


@pytest.mark.parametrize("maker,want", [
    ("torch.zeros(2, 4)", (8, None)),                      # no positional dtype
    ("torch.zeros(2, 4, dtype=torch.float64)", (8, "torch.float64")),
    ("torch.ones(3, device='cpu', dtype=torch.bfloat16)", (3, "torch.bfloat16")),
    ("torch.tensor([1, 2, 3], dtype=torch.int32)", (3, "torch.int32")),
    ("torch.zeros(n, 4)", None),                           # unresolved: silent
    ("torch.tensor([[1, 2], [3]])", None),                 # ragged: silent
    ("torch.zeros_like(y)", None),
])
def test_torch_buffer_reading(maker, want):
    assert _dtypes(maker) == want


def test_dtype_mismatch_across_branches_reads_dtype_keyword():
    src = ("import torch\n"
           "import tpu_mpi_torch as MPI\n"
           "comm = MPI.COMM_WORLD\n"
           "rank = MPI.Comm_rank(comm)\n"
           "if rank == 0:\n"
           "    x = torch.zeros(4, dtype=torch.float32)\n"
           "    MPI.Allreduce(x, MPI.SUM, comm)\n"
           "else:\n"
           "    y = torch.zeros(4, dtype=torch.float64)\n"
           "    MPI.Allreduce(y, MPI.SUM, comm)\n")
    assert [d.code for d in plint.lint_source(src, "dt.py")] == ["L103"]
