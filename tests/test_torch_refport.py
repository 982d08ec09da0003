"""Reference test files rebuilt against the port.

:func:`port_module` reads one of the JAX package's test files, points every
``tpu_mpi`` import at ``tpu_mpi_torch``, places what would default to the
card on the CPU (``DeviceBuffer(...)``, ``Broker(...)``, ``_ThreadPool(...)``,
``Win_allocate_shared(...)`` and ``PagedKVCache(...)`` gain
``device="cpu"``; a jax array
(``jnp.asarray``) becomes a raw CPU tensor), and executes it as a module
of its own. :func:`adopt` copies its tests and fixtures into a port test
file, where they run under their reference names: each reference test's
own checks hold the port to what the JAX package computes.

The array-type fixture ``AT`` of a rebuilt module is the port's: numpy
arrays, ``DeviceBuffer(device="cpu")`` cells and raw CPU tensors.
"""

import ast
import atexit
import os
import re
import shutil
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

import tpu_mpi.testing  # noqa: F401  (conftest's nprocs fixture reads it)

TESTS = os.path.dirname(os.path.abspath(__file__))

_ON_CPU = ("DeviceBuffer", "Broker", "_ThreadPool", "Win_allocate_shared",
           "PagedKVCache")


class _OnCpu(ast.NodeTransformer):
    """``device="cpu"`` for every call that would default to the card, and
    a CPU tensor for every jax array the reference makes."""

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else None
        if name in _ON_CPU and not any(k.arg in ("device", None)
                                       for k in node.keywords):
            node.keywords.append(ast.keyword(arg="device",
                                             value=ast.Constant("cpu")))
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "jnp" and f.attr in ("asarray", "array"):
            node.func = ast.Name(id="_port_tensor", ctx=ast.Load())
        return node


def _port_tensor(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


class _Kind:
    """One array type of the port's ``AT`` fixture."""

    def __init__(self, name, wrap):
        self.name = name
        self.wrap = wrap

    def array(self, data, dtype=None):
        return self.wrap(np.array(data, dtype=dtype))

    def empty(self, shape, dtype=np.float64):
        return self.wrap(np.zeros(shape, dtype=dtype))

    def zeros(self, shape, dtype=np.float64):
        return self.wrap(np.zeros(shape, dtype=dtype))

    def full(self, shape, val, dtype=None):
        return self.wrap(np.full(shape, val, dtype=dtype))


def _kinds():
    from tpu_mpi_torch.buffers import DeviceBuffer
    return [_Kind("numpy", lambda a: a),
            _Kind("device", lambda a: DeviceBuffer(a, device="cpu")),
            _Kind("tensor", lambda a: torch.from_numpy(np.array(a)))]


@pytest.fixture(params=_kinds(), ids=lambda k: k.name)
def AT(request):
    """The port's array types: numpy, CPU DeviceBuffer, raw CPU tensor."""
    return request.param


_SCRATCH = []


def _scratch() -> str:
    """This process's scratch directory for the rebuilt tests' files,
    removed at exit; a path that can stand inside any string literal."""
    if not _SCRATCH:
        path = tempfile.mkdtemp(prefix="tpu_mpi_torch_refport_")
        assert not set(path) & set("{}'\"\\"), path
        atexit.register(shutil.rmtree, path, True)
        _SCRATCH.append(path)
    return _SCRATCH[0]


CORPUS = os.path.join(TESTS, "analyze_corpus")
# the reference's own line that names its corpus directory
CORPUS_LINE = (r'CORPUS = os\.path\.join\(os\.path\.dirname\(os\.path\.abspath'
               r'\(__file__\)\),\s*"analyze_corpus"\)')


def port_corpus() -> str:
    """The analysis corpus (``tests/analyze_corpus/``) rewritten for the
    port in this process's scratch directory: every ``tpu_mpi`` name
    points at ``tpu_mpi_torch``, line for line, so each ``# lint:`` /
    ``# trace:`` marker keeps its line. Returns the directory."""
    out = os.path.join(_scratch(), "analyze_corpus")
    if not os.path.isdir(out):
        tmp = out + ".part"
        os.makedirs(tmp)
        for name in sorted(os.listdir(CORPUS)):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(CORPUS, name)) as f:
                lines = f.read().split("\n")
            with open(os.path.join(tmp, name), "w") as f:
                f.write("\n".join(re.sub(r"\btpu_mpi\b", "tpu_mpi_torch", ln)
                                  for ln in lines))
        os.rename(tmp, out)
    return out


def corpus_subs() -> tuple:
    """``port_module`` rewrites that point a reference analysis test's
    ``CORPUS`` at :func:`port_corpus`'s copy."""
    return ((CORPUS_LINE, f"CORPUS = {port_corpus()!r}"),)


def port_module(ref: str, subs=()) -> types.ModuleType:
    """``tests/<ref>.py`` rebuilt against the port (module docstring).
    ``subs`` are extra ``(pattern, replacement)`` rewrites of its source,
    for a line that names the JAX package's internals."""
    name = f"torchport_{ref}"
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(TESTS, ref + ".py")
    with open(path) as f:
        src = f.read()
    src = re.sub(r"\btpu_mpi\b", "tpu_mpi_torch", src)
    # the scratch files the reference writes (and its child processes
    # write and it reads back) under fixed /tmp names go to a directory of
    # this process's under the temp dir, so neither a reference file and
    # its rebuild nor two checkouts with temp dirs of their own collide
    scratch = _scratch()
    src = re.sub(r"\btpu_mpi_(serve_doomed|online_|conv_rank|autoarm_rank)",
                 r"tpu_mpi_torch_\1", src)
    src = re.sub(r'("/tmp")(?=, f"tpu_mpi_torch_)|/tmp/(?=tpu_mpi_torch_)',
                 lambda m: f'"{scratch}"' if m.group(1) else f"{scratch}/",
                 src)
    # Broker(...) inside the scripts a test runs in a subprocess
    src = re.sub(r"\bBroker\((?=\s*\w+\s*=)", 'Broker(device="cpu", ', src)
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n, f"{ref}: rewrite {pat!r} matched nothing"
    tree = _OnCpu().visit(ast.parse(src, path))
    code = compile(ast.fix_missing_locations(tree), path, "exec")
    mod = types.ModuleType(name)
    mod.__file__ = path
    mod._port_tensor = _port_tensor
    mod._port_source = src
    sys.modules[name] = mod
    exec(code, mod.__dict__)
    return mod


def _is_fixture(v) -> bool:
    return type(v).__name__ == "FixtureFunctionDefinition" \
        or hasattr(v, "_pytestfixturefunction")


def adopt(namespace: dict, mod: types.ModuleType, skip=()) -> list:
    """Copy ``mod``'s tests (all but ``skip``) and fixtures into a test
    file's ``namespace``, with the port's ``AT``; returns the names."""
    names = []
    for k, v in vars(mod).items():
        if k in skip:
            continue
        if (k.startswith("test_") and callable(v)) or _is_fixture(v):
            namespace[k] = v
            names.append(k)
    namespace["AT"] = AT
    return names


# -- the rewrite itself ------------------------------------------------------

def test_rewrite_places_device_defaults_on_the_cpu():
    src = ("b = Broker(nranks=2)\nx = MPI.DeviceBuffer(a)\n"
           "y = DeviceBuffer(a, device='cuda')\nz = jnp.asarray(a)\n")
    out = ast.unparse(_OnCpu().visit(ast.parse(src)))
    assert "Broker(nranks=2, device='cpu')" in out
    assert "MPI.DeviceBuffer(a, device='cpu')" in out
    assert "DeviceBuffer(a, device='cuda')" in out          # left as asked
    assert "_port_tensor(a)" in out


@pytest.mark.parametrize("ref", ["test_serve", "test_tune_online",
                                 "test_serve_frontdoor", "test_serve_scale"])
def test_rebuilt_modules_write_nothing_under_a_fixed_tmp_path(ref):
    """A rebuilt test and the processes it starts write their scratch
    files under this process's temp dir, never under a fixed /tmp name."""
    src = port_module(ref)._port_source
    if ref in ("test_serve", "test_tune_online"):
        assert _scratch() in src
    src = src.replace(_scratch(), "SCRATCH")
    assert not re.findall(r"/tmp/tpu_mpi|\"/tmp\",", src)
    # a socket path the reference only parses stays as written
    if ref == "test_serve":
        assert '"/tmp/x.sock"' in src


@pytest.mark.parametrize("ref", ["test_serve", "test_overlap",
                                 "test_perfvars", "test_telemetry",
                                 "test_infer", "test_elastic"])
def test_rebuilt_module_names_only_the_port(ref):
    mod = port_module(ref)
    bound = {getattr(v, "__name__", "") for v in vars(mod).values()
             if isinstance(v, types.ModuleType)}
    assert not any(n == "tpu_mpi" or n.startswith("tpu_mpi.")
                   for n in bound), bound
    assert adopt({}, mod)
