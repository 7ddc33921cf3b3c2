"""A tiny CPU rehearsal of every traffic kind through the program's CPU
path (never a measurement): the run's result line has the cell's metrics
and comes out correct."""

import time

import pytest
import torch

from gspbench import bench

from conftest import ROOT

CELLS = [w["name"] for w in bench.load_spec(ROOT)["workloads"]]
KIND_CELLS = {}
for _name in CELLS:
    KIND_CELLS.setdefault(bench.find_cell(bench.load_spec(ROOT), _name).traffic["kind"], _name)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", sorted(KIND_CELLS.values()))
def test_rehearsal(tiny_cell, name, trace):
    cell = tiny_cell(name)
    # A traced run needs a few calls after the slice's start, a quarter into the window.
    seconds = 2.5 if trace else 0.6
    res = bench.run_cell(cell, 2**31 + 7, seconds, trace, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["failed"] == 0 and res["attempted"] > 0
    if trace:
        want = {m["name"] for m in cell.per_layer}
        assert set(res["metrics"]) <= want and "prep_s" in res["metrics"]
        assert res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in res["metrics"].values())
