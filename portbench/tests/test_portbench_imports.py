"""What a run loads: no JAX, no JAX library, no JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and a
reference that loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_mpi"}

RUN_TINY = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
from conftest import ROOT, tiny
from portbench import harness
cell = {cell!r}
m = harness.load_json(ROOT / "BENCHMARK.json")
res, err, _ = harness.run_cell(m, harness.HERE.parent, cell, 2**31 + 77, 0.3, False,
                               torch.device("cpu"), **tiny(cell))
print(json.dumps({{"modules": sorted({{n.split(".")[0] for n in sys.modules}})}}))
"""


def run_python(code, env_extra=None):
    import os
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=600)


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_a_run_loads_no_jax(cell):
    out = run_python(RUN_TINY.format(root=str(ROOT), tests=str(Path(__file__).parent),
                                     cell=cell))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tpu_mpi_torch" in got["modules"]
    assert not FORBIDDEN & set(got["modules"])


def test_the_harness_refuses_a_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "allreduce.f32.256MiB", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_imports_nothing_of_the_port():
    for path in sorted((ROOT / "portbench" / "reference").glob("*.py")):
        for name in imported_names(path):
            top = name.lstrip(".").split(".")[0]
            assert top not in FORBIDDEN | {"tpu_mpi_torch"}, (path.name, name)
            if name.startswith("."):
                assert name.startswith(".") and not name.startswith(".."), (path.name, name)
    out = run_python(
        f"import sys; sys.path.insert(0, {str(ROOT)!r});"
        "import portbench.reference.flagship, portbench.reference.fold;"
        "print(sorted({n.split('.')[0] for n in sys.modules}))")
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip()))
    assert "tpu_mpi_torch" not in loaded and not FORBIDDEN & loaded
