"""The control and the faults each drive a whole run, here on the CPU at a
tiny size, and ``correct`` has to come out false; the same run sound comes
out true. The chip's look for a card is skipped: ``run_cell`` is handed the
CPU."""

import pytest
import torch

from conftest import ROOT, tiny
from portbench import control, harness
from portbench.check import verdict

CPU = torch.device("cpu")
SEED = 2 ** 32 + 11


MANIFEST = harness.load_json(ROOT / "BENCHMARK.json")


def run(cell, **extra):
    res, err, _ = harness.run_cell(MANIFEST, ROOT, cell, SEED, 0.3, False, CPU,
                                   **tiny(cell), **extra)
    return res


ALLREDUCE = [w["name"] for w in MANIFEST["workloads"] if w["config"] == "allreduce-4rank-f32"]
TRAIN = ["flagship.ddp4.b2x1024", "flagship.sp4.b8x1024"]


@pytest.mark.parametrize("cell", ALLREDUCE)
def test_allreduce_sound_run_is_correct(cell):
    assert run(cell)["correct"] is True


@pytest.mark.parametrize("fault", ("control",) + control.ALLREDUCE_FAULTS)
@pytest.mark.parametrize("cell", ALLREDUCE)
def test_allreduce_fault_is_caught(cell, fault):
    t = tiny(cell)
    with control.plant(cell, fault, SEED, device=CPU, **t):
        res = run(cell)
    assert res["correct"] is False
    assert res["checks"]["mismatched_elements"]["value"] > 0


@pytest.mark.parametrize("fault", control.TRAIN_FAULTS)
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_is_caught(cell, fault):
    with control.plant(cell, fault, **tiny(cell)):
        res = run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_and_planted_faults_read_over_the_limits(cell):
    limits = harness.load_json(ROOT / "portbench" / "workloads" / f"{cell}.json")["limits"]
    readings = control.train_readings(cell, SEED, CPU, **tiny(cell))
    for name, numbers in readings.items():
        ok, _ = verdict(numbers, limits)
        assert not ok, (name, numbers)
