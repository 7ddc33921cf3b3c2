"""The per-layer metrics read from the program's own spans: a tiny CPU
rehearsal of one cell of each traffic kind with ``--trace 1`` reads every
one of them, and each reads nothing where the program has no recorder
(``repro_torch.telemetry`` cannot be imported, as at an older commit)."""

import time

import pytest
import torch

from gspbench import bench

from conftest import ROOT

SPEC = bench.load_spec(ROOT)
CELLS = {w["name"]: bench.find_cell(SPEC, w["name"]) for w in SPEC["workloads"]}
SENSOR_CELLS = [n for n, c in CELLS.items() if c.config["program"] == "sensor_sgwt"]


def _span_metrics(cell):
    return sorted(m["name"] for m in cell.per_layer if m["source"] == "program_span")


# One cell of each traffic kind whose cells list span metrics.
KIND_CELLS = {}
for _name, _cell in CELLS.items():
    if _span_metrics(_cell):
        KIND_CELLS.setdefault(_cell.traffic["kind"], _name)


def test_every_kind_of_the_sensor_program_reads_spans():
    assert {CELLS[n].traffic["kind"] for n in SENSOR_CELLS} <= set(KIND_CELLS)


@pytest.mark.parametrize("name", sorted(KIND_CELLS.values()))
def test_span_metrics_read_a_number(tiny_cell, name, monkeypatch):
    import repro_torch
    from repro_torch import telemetry

    cell = tiny_cell(name)
    cell.traffic["trace_s"] = 1.5  # enough frames and panels inside the slice, on a busy host
    wanted = _span_metrics(cell)
    assert wanted
    telemetry.clear()
    res = bench.run_cell(cell, 2**31 + 11, 4.0, True, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    for metric in wanted:
        assert res["metrics"][metric]["value"] > 0.0, metric
        assert res["metrics"][metric]["unit"] == "ms"

    monkeypatch.delattr(repro_torch, "telemetry")
    monkeypatch.setitem(__import__("sys").modules, "repro_torch.telemetry", None)
    for metric in wanted:
        assert bench.load_reader(metric)(None) is None, metric


def _workloads(metric):
    return next(m["workloads"] for m in SPEC["per_layer"] if m["name"] == metric)


def test_readers_read_nothing_without_a_session():
    from repro_torch import telemetry

    telemetry.clear()
    names = sorted(m["name"] for m in SPEC["per_layer"] if m["source"] == "program_span")
    assert len([m for m in names if set(SENSOR_CELLS) & set(_workloads(m))]) == 7
    for metric in names:
        assert bench.load_reader(metric)(None) is None, metric
