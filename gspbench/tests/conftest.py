"""Shared helpers of the benchmark's tests: the checkout root and ``src``
on the path, torch's ``exp`` warmed up (the CPU build's first ``exp`` across
several threads can come back up to 1e-4 off), and cells shrunk by their
program to a size the CPU runs in seconds."""

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


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell from BENCHMARK.json, shrunk by its
    program's ``tiny`` to a size the CPU runs in seconds."""

    def make(name: str) -> bench.Cell:
        cell = bench.find_cell(bench.load_spec(ROOT), name)
        cell.program.tiny(cell)
        return cell

    return make
