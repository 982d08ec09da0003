"""A short run of each cell on the card, through the command the driver
runs (``python -m pytest -m cuda portbench/tests`` on a machine with a
card); skips where there is none."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_a_short_run_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 33 + 5), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
    else:
        assert "setup_s" in line["metrics"]
