"""Shared helpers of the benchmark's tests: the checkout root and ``src``
on the path, torch's ``exp`` warmed up (the CPU build's first ``exp`` across
several threads can come back up to 1e-4 off), and cells shrunk to a size
the CPU runs in seconds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from gspbench import bench  # noqa: E402

torch.exp(torch.linspace(0.0, 1.0, 1 << 20))

TINY_N, TINY_F = 384, 8


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell from BENCHMARK.json at N = 384, F = 8,
    FISTA-4, a light serving load and short trace slices."""

    def make(name: str) -> bench.Cell:
        cell = bench.find_cell(bench.load_spec(ROOT), name)
        cell.config["n_vertices"] = TINY_N
        t = cell.traffic
        t["trace_s"] = 0.2
        if "panel_width" in t:
            t["panel_width"] = TINY_F
        if t["kind"] == "lasso_closed":
            t["n_iters"] = 4
        if t["kind"] == "serve_open":
            t.update(rate=100.0, max_panel=16, frame_streams=4, samples=[6, 3, 2],
                     lane_mix=[0.6, 0.2, 0.2])
        return cell

    return make
