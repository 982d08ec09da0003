"""Fixtures of the benchmark's own tests (run from the repo root:
``python -m pytest portbench/tests``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA card, for tests marked ``cuda``; skips where there is none
    (decided here, never while a module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture
def manifest():
    from portbench import harness
    return harness.load_json(ROOT / "BENCHMARK.json")


# a flagship small enough for the CPU: every width cut, the block as it is
TINY_FLAGSHIP = {"n_embd": 32, "n_head": 4, "n_inner": 64, "n_positions": 16,
                 "n_layer": 2, "vocab_size": 64, "dtype": "bfloat16"}


def tiny(cell: str) -> dict:
    """Config and traffic overrides that run ``cell`` on the CPU in a second."""
    from portbench import harness
    m = harness.load_json(ROOT / "BENCHMARK.json")
    w = harness.find(m["workloads"], cell, "workload")
    entry = harness.find(m["configs"], w["config"], "config")
    traffic = harness.load_json(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
    out = {"traffic": traffic, "config": harness.load_json(ROOT / entry["file"])}
    if traffic["driver"] == "allreduce_loop":
        traffic["size_bytes"] = 1 << 14
        traffic["samples"] = 4
        traffic["sample_upto"] = 16
        traffic["warm"] = 2
    else:
        out["config"] = dict(TINY_FLAGSHIP)
        traffic["batches"] = 6
    return out
