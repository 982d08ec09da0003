"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import importlib
import json
import re

from portbench import endtoend, harness

ROOT = harness.HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names(manifest):
    assert set(manifest) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads", "per_layer"):
                    assert one_line(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    assert all(one_line(w) for w in manifest["command"]) and len(manifest["command"]) <= 32


def test_paths_and_command(manifest):
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in manifest["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"])
    assert 1 <= manifest["run_seconds"] <= 51 and int(manifest["run_seconds"]) == manifest["run_seconds"]


def test_cells_configs_and_files_found_by_name(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    pairs = set()
    for c in configs.values():
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        data = json.loads((ROOT / c["file"]).read_text())
        assert len(data["source"]) <= 200
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in data for k in c["reduced"])
        assert "assumed" in data
    assert len({c["file"] for c in configs.values()}) == len(configs)
    used = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        traffic = json.loads((harness.HERE / "traffic" / f"{w['traffic']}.json").read_text())
        importlib.import_module(f"portbench.drivers.{traffic['driver']}").run
        limits = json.loads((harness.HERE / "workloads" / f"{w['name']}.json").read_text())
        assert limits["limits"]
    assert used == set(configs)
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(manifest["workloads"]) // 4)


def test_metrics_found_and_reported(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["name"].split(".")[0] in endtoend.METRICS
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert harness.reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        reported = [n for n, m in e2e.items() if harness.reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(harness.reports(m, cell) for m in manifest["per_layer"]), cell
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) <= {"front door", "trainer", "model step", "kernels", "device"}
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
