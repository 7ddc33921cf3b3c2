"""The control, the reference in float32 with TF32 Laplacian products in
the program's place, comes out not correct: on the CPU at a test size for
every traffic kind, and on the card at each cell's own size (``cuda``)."""

import time

import pytest
import torch

from gspbench import bench

from conftest import ROOT
from test_gspbench_rehearsal import KIND_CELLS


def _fails_a_limit(cell, control):
    return any(control[k] > limit for k, limit in cell.traffic["limits"].items())


@pytest.mark.parametrize("name", sorted(KIND_CELLS.values()))
def test_control_fails_on_the_cpu(tiny_cell, name):
    cell = tiny_cell(name)
    program, control = bench.readings(cell, 5, torch.device("cpu"), 0.4)
    assert all(program[k] <= limit for k, limit in cell.traffic["limits"].items()), program
    assert _fails_a_limit(cell, control), control


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in bench.load_spec(ROOT)["workloads"]])
def test_control_fails_on_the_card_at_full_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the card")
    cell = bench.find_cell(bench.load_spec(ROOT), name)
    for seed in (101, 102, 103):
        t0 = time.perf_counter()
        program, control = bench.readings(cell, seed, torch.device("cuda", 0), 2.0)
        assert _fails_a_limit(cell, control), (seed, control)
        assert not _fails_a_limit(cell, program), (seed, program)
        assert time.perf_counter() - t0 < 300
