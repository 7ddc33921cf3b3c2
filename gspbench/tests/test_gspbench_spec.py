"""Every cell of BENCHMARK.json resolves by name to its configuration,
traffic and metric readers, within the benchmark contract's limits."""

import json
import re

import pytest

from gspbench import bench, drivers

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "gspbench/run.py"]
    assert SPEC["paths"] == ["gspbench"] and all(PATH.match(p) for p in SPEC["paths"])
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["reduced"] == ["n_vertices"]
    assert entry["file"].startswith("gspbench/configs/") and (ROOT / entry["file"]).is_file()
    config = json.loads((ROOT / entry["file"]).read_text())
    # The cut from the project's own production field is named with its cause.
    assert "262,144" in config["assumed"]["n_vertices"]
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert 1 <= len(entry["why"]) <= 200 and 1 <= len(entry["source"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(w["traffic"]) and w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    cell = bench.find_cell(SPEC, name)
    assert cell.traffic["kind"] in drivers.KINDS
    assert cell.traffic["limits"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(bench.load_reader(m["name"]))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in SPEC["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200
    assert set(metric) <= allowed and allowed - {"workloads"} <= set(metric)
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in SPEC["per_layer"]:
        # The harness reports a per-layer metric in the cells it lists.
        assert metric["workloads"]


def test_unique_names():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
