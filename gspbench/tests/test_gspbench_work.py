"""The operation and byte counters: exact on a hand-built graph, and
unchanged when the program tiles the same graph at B = 8 or B = 16; the
serving trace's work is the same for every seed."""

import numpy as np
import pytest
import torch

from gspbench import loadgen, work
from gspbench.reference import graph

# A path 0-1-2-3 and a triangle 3-4-5 on a line of sensors 0.1 apart:
# kappa 0.15 joins neighbours only, except 4-5 and 3-5 which sit closer.
COORDS = torch.tensor([[0.0, 0.0], [0.1, 0.0], [0.2, 0.0], [0.3, 0.0],
                       [0.4, 0.0], [0.35, 0.06]], dtype=torch.float32)
EDGES = {(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (3, 5)}


def _lap():
    return graph.sensor_laplacian(COORDS, 0.1, 0.15)


def test_hand_built_graph_counts():
    lap = _lap()
    got = {(int(i), int(j)) for i, j in zip(lap.rows, lap.cols) if i < j}
    assert got == EDGES
    assert lap.nnz == 2 * 6 + 6 == 18


def test_apply_and_adjoint_work_exact():
    n, f, eta, m, nnz = 6, 3, 5, 20, 18
    assert work.apply_work(nnz, n, f, eta, m) == (
        2 * (20 * 18 * 3 + 5 * 21 * 6 * 3),
        18 * 8 + 7 * 4 + 6 * 3 * 4 + 5 * 6 * 3 * 4,
    )
    assert work.adjoint_work(nnz, n, f, eta, m) == (
        2 * (20 * 18 * 5 * 3 + 5 * 21 * 6 * 3),
        18 * 8 + 7 * 4 + 5 * 6 * 3 * 4 + 6 * 3 * 4,
    )


def test_bound_names_its_limit():
    t, which = work.bound_seconds(67e12, 1.0)
    assert (t, which) == (pytest.approx(1.0), "operations")
    t, which = work.bound_seconds(1.0, 3.35e12)
    assert (t, which) == (pytest.approx(1.0), "bytes")


@pytest.mark.parametrize("block", [8, 16])
def test_counts_ignore_the_tiling(block):
    """The program's Block-ELL tiles at B = 8 and 16 hold the same nonzeros
    (padding differs); the work is counted from those, never from tiles."""
    from repro_torch.core.graph import SensorGraph, gaussian_kernel_weights
    from repro_torch.filters import GraphFilter

    g = SensorGraph(gaussian_kernel_weights(COORDS, 0.1, 0.15), COORDS)
    filt = GraphFilter.from_coefficients(torch.ones(5, 21).double().numpy(), 4.0, graph=g)
    bell = filt.prepare_backend("bsr", block_size=block).bell
    assert int(torch.count_nonzero(bell.blocks)) == _lap().nnz
    assert bell.n_block_rows * bell.k_max * block * block > _lap().nnz  # padding, not counted
    assert work.apply_work(_lap().nnz, 6, 4, 5, 20) == work.apply_work(18, 6, 4, 5, 20)


def test_trace_reduction_on_a_hand_built_trace():
    """Busy union, idle gaps by the innermost open span, and ops by name."""
    from gspbench import profiling

    device = [("k1", 10, 20), ("k2", 15, 30), ("k1", 50, 60), ("copy", 95, 120)]
    spans = [("step", 0, 40), ("submit", 42, 48), ("step", 45, 70), ("wait", 55, 58),
             ("wait", 70, 100)]
    s = profiling.summarize(device, spans, (5, 100), unit=1.0)
    assert s.busy_s == 20 + 10 + 5 and s.window_s == 95
    assert s.idle_share == pytest.approx(100 * (1 - 35 / 95))
    # gaps: 5-10 (step), 30-50 (mid 40: no span), 60-95 (mid 77.5: wait)
    assert s.idle_gaps == [["wait", 35.0], ["none", 20.0], ["step", 5.0]]
    assert s.device_ops == [["k1", 20.0], ["k2", 15.0], ["copy", 5.0]]
    assert profiling.short_name(
        "void (anonymous namespace)::cheb_union_kernel<8, float>(float const*, int)"
    ) == "cheb_union_kernel<8, float>"


def test_trace_composition_is_the_same_for_every_seed():
    kw = dict(hot_frac=0.01, hot_mass=0.5, lane_mix=[0.90, 0.08, 0.02], n_tenants=8, n_signals=64)
    a = loadgen.make_trace(100_000, 2.0, 2400.0, seed=2**31 + 11, **kw)
    b = loadgen.make_trace(100_000, 2.0, 2400.0, seed=2**31 + 12, **kw)
    assert len(a["t_arrive"]) == len(b["t_arrive"]) == 4800
    np.testing.assert_allclose(np.sort(np.diff(a["t_arrive"], prepend=0.0)),
                               np.sort(np.diff(b["t_arrive"], prepend=0.0)), rtol=0, atol=1e-12)
    assert abs(a["t_arrive"][-1] - 2.0) < 0.05
    assert np.bincount(a["lane"]).tolist() == np.bincount(b["lane"]).tolist() == [4320, 384, 96]
    assert np.count_nonzero(a["stream"] < 1000) >= 2400 <= np.count_nonzero(b["stream"] < 1000)
    assert not np.array_equal(a["lane"], b["lane"])
    assert not np.array_equal(a["t_arrive"], b["t_arrive"])
