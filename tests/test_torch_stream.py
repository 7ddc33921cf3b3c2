"""Port parity for the streaming lane: ``GraphFilter.apply_sparse``,
``repro_torch.stream`` and ``repro_torch.apps.streaming``, case for case
with ``tests/test_stream.py`` (the two engine-lane tests wait for the
serving slice) and held against the live reference on the same numpy
inputs.

* ``apply_sparse`` against a full apply: 1e-5, on ``dense`` (restricted)
  and ``bsr`` (the fallback, through the kernels' plain versions here).
* Streams: every output within 1e-5 of the full refilter on ``dense`` and
  ``bsr``; modes, ``changed``, ``active`` and words equal the reference
  lane's; the ``tab_streaming`` cell of ``BENCH_pr10.json`` (80 x 80 grid,
  M = 20, 8 parts) reproduced exactly.
* Warm starts: iteration counts equal the live reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import streaming_denoise as jstreaming_denoise
from repro.apps import streaming_wavelet_denoise as jstreaming_wavelet
from repro.core import distributed as jdist
from repro.core import graph as jgraph
from repro.core import multipliers as jmult
from repro.filters import GraphFilter as JFilter
from repro.solvers import GramProblem as JGram
from repro.solvers import LassoProblem as JLasso
from repro.solvers import conjugate_gradient as jcg
from repro.solvers import fista as jfista
from repro.solvers import ista as jista
from repro.stream import StreamingFilter as JStream
from repro.stream import StreamingLasso as JStreamingLasso
from repro.stream import StreamingWiener as JStreamingWiener
from repro_torch import interop
from repro_torch.apps import streaming_denoise, streaming_wavelet_denoise
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.core import multipliers as tmult
from repro_torch.filters import GraphFilter, backend_supports_sparse
from repro_torch.solvers import GramProblem, LassoProblem, conjugate_gradient, fista, ista
from repro_torch.stream import (
    StreamingFilter,
    StreamingLasso,
    StreamingWiener,
    stream_fista,
    stream_ista,
    stream_wiener,
)

SIDE = 32  # grid scenes: diameter 2*(SIDE-1) >> order, so deltas stay local
ORDER = 8


@pytest.fixture(scope="module")
def grid_setting():
    """32x32 grid + Tikhonov/heat union filter, in both packages."""
    g = tgraph.grid_graph(SIDE, device="cpu")
    jg = jgraph.grid_graph(SIDE)
    filt = GraphFilter.from_multipliers(
        [tmult.tikhonov(1.0, 1), tmult.heat(0.5)], order=ORDER, graph=g, lmax=8.0)
    jfilt = JFilter.from_multipliers(
        [jmult.tikhonov(1.0, 1), jmult.heat(0.5)], order=ORDER, graph=jg, lmax=8.0)
    f0 = (g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2).numpy()
    return g, filt, jfilt, f0


@pytest.fixture(scope="module")
def sensor_setting():
    """96-node sensor graph (the reference's draw) + SGWT filter."""
    jg = jgraph.connected_sensor_graph(jax.random.PRNGKey(1), n=96, sigma=0.17, kappa=0.18)
    a, coords = np.asarray(jg.adjacency), np.asarray(jg.coords)
    g = interop.sensor_graph_from_numpy(a, coords, "cpu")
    lmax = float(jg.lmax_bound())
    f0 = (coords[:, 0] ** 2 + coords[:, 1] ** 2 - 1.0).astype(np.float32)
    rng = np.random.default_rng(2)
    y0 = f0 + 0.3 * rng.normal(size=96).astype(np.float32)
    y1 = y0.copy()
    ch = rng.choice(96, size=5, replace=False)
    y1[ch] += 0.1 * rng.normal(size=5).astype(np.float32)
    filt = GraphFilter.from_multipliers(tmult.sgwt_filter_bank(lmax, n_scales=3), 16,
                                        graph=g, lmax=lmax)
    jfilt = JFilter.from_multipliers(jmult.sgwt_filter_bank(lmax, n_scales=3), 16,
                                     graph=jg, lmax=lmax)
    return g, jg, filt, jfilt, y0, y1


def _patch_frame(f0, r0, c0, patch=3, bump=0.5):
    y = f0.copy()
    rr, cc = np.meshgrid(np.arange(r0, r0 + patch), np.arange(c0, c0 + patch), indexing="ij")
    y[(rr * SIDE + cc).ravel()] += bump
    return y


def _full(filt, y, backend="dense"):
    return filt.apply(torch.as_tensor(y), backend=backend).numpy()


def _same_record(res, ref):
    assert (res.mode, res.frame, res.changed, res.active, res.words, res.edges_changed) == (
        ref.mode, ref.frame, ref.changed, ref.active, ref.words, ref.edges_changed)


# ---- K-hop masks -------------------------------------------------------------


def test_khop_neighborhood_path_graph():
    n = 12
    a = np.zeros((n, n))
    idx = np.arange(n - 1)
    a[idx, idx + 1] = a[idx + 1, idx] = 1.0
    s = np.zeros(n, bool)
    s[5] = True
    for k in range(4):
        want = np.zeros(n, bool)
        want[5 - k : 5 + k + 1] = True
        np.testing.assert_array_equal(tgraph.khop_neighborhood(a, s, k), want)
    np.testing.assert_array_equal(tgraph.khop_neighborhood(a, np.array([5]), 2),
                                  tgraph.khop_neighborhood(a, s, 2))


def test_khop_matches_polynomial_support(grid_setting):
    g, _, _, _ = grid_setting
    lap = g.laplacian().double().numpy()
    s = np.zeros(g.n_vertices, bool)
    s[[5 * SIDE + 7, 20 * SIDE + 25]] = True
    for k in range(4):
        got = tgraph.khop_neighborhood(g.adjacency.numpy(), s, k)
        want = np.linalg.matrix_power(lap, k) @ s.astype(np.float64) != 0.0
        assert not np.any(want & ~got)


# ---- sparse apply ------------------------------------------------------------


def test_sparse_capability_flags():
    assert backend_supports_sparse("dense")
    for name in ("matvec", "bsr", "halo", "allgather", "grid"):
        assert not backend_supports_sparse(name), name


@pytest.mark.parametrize("batched", [False, True])
def test_apply_sparse_matches_full_apply(grid_setting, batched):
    """Restricted-support apply == full apply of the same delta (1e-5),
    and == the reference's restricted apply; a tensor support and a
    precomputed reach give the same answer."""
    g, filt, jfilt, _ = grid_setting
    rng = np.random.default_rng(0)
    delta = np.zeros(g.n_vertices, np.float32)
    s = rng.choice(g.n_vertices, size=9, replace=False)
    delta[s] = rng.normal(size=9).astype(np.float32)
    if batched:
        delta = np.stack([delta, 2.0 * delta], axis=1)
    support = (delta != 0.0) if delta.ndim == 1 else (delta != 0.0).any(axis=1)
    got = filt.apply_sparse(torch.as_tensor(delta), support).numpy()
    np.testing.assert_allclose(got, _full(filt, delta), atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jfilt.apply_sparse(jnp.asarray(delta), support)), atol=1e-5)
    reach = tgraph.khop_neighborhood(g.adjacency.numpy(), support, ORDER)
    assert 0 < reach.sum() < g.n_vertices
    assert not got[:, ~reach].any()
    again = filt.apply_sparse(torch.as_tensor(delta), torch.as_tensor(support), reach=reach)
    assert torch.equal(again, torch.as_tensor(got))


def test_apply_sparse_wide_reach_and_fallback_backend(grid_setting):
    """A reach whose bucket covers the graph runs the full apply; a backend
    without the capability (``bsr``, on the kernels' plain versions here)
    still answers correctly."""
    g, filt, _, _ = grid_setting
    delta = np.zeros(g.n_vertices, np.float32)
    delta[100] = 1.0
    want = _full(filt, delta)
    got = filt.apply_sparse(torch.as_tensor(delta), delta != 0.0, backend="bsr")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    wide = np.ones(g.n_vertices, bool)
    got = filt.apply_sparse(torch.as_tensor(delta), delta != 0.0, reach=wide)
    assert torch.equal(got, filt.apply(torch.as_tensor(delta)))


# ---- delta filtering ---------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_streaming_parity_vs_full_refilter(grid_setting, backend):
    """Every streamed frame's output == the full refilter of that frame to
    1e-5, and each record equals the reference lane's."""
    g, filt, jfilt, f0 = grid_setting
    lane = StreamingFilter(filt, backend=backend, device="cpu")
    jlane = JStream(jfilt, backend="dense")
    frames = [f0] + [_patch_frame(f0, 4 + 5 * t, 6 + 4 * t) for t in range(3)]
    for y in frames:
        res = lane.push(y)
        ref = jlane.push(y)
        if backend == "dense":
            _same_record(res, ref)
        else:  # no restriction: the whole graph is active on every frame
            assert (res.mode, res.changed, res.active) == (ref.mode, ref.changed, g.n_vertices)
        assert res.out.device == g.device
        np.testing.assert_allclose(res.out.numpy(), _full(filt, y, backend), atol=1e-5)
    assert lane.delta_frames == len(frames) - 1 and lane.full_refilters == 1


def test_streaming_modes_and_thresholds(grid_setting):
    g, filt, jfilt, f0 = grid_setting
    lane = StreamingFilter(filt, backend="dense", max_delta_frac=0.05, device="cpu")
    jlane = JStream(jfilt, backend="dense", max_delta_frac=0.05)
    r0 = lane.push(f0)
    assert r0.mode == "full" and r0.changed == g.n_vertices
    r1 = lane.push(f0)
    assert r1.mode == "cached" and r1.words == 0 and r1.active == 0
    assert torch.equal(r1.out, r0.out)
    y = _patch_frame(f0, 10, 10)
    r2 = lane.push(y)
    assert r2.mode == "delta" and r2.changed == 9
    assert r2.changed < r2.active < g.n_vertices
    y2 = y + np.linspace(0, 1, g.n_vertices).astype(np.float32)
    r3 = lane.push(y2)
    assert r3.mode == "full"
    for res, frame in zip((r0, r1, r2, r3), (f0, f0, y, y2)):
        _same_record(res, jlane.push(frame))


def test_frame_result_times_host_work(grid_setting):
    """``host_s`` times the push's host algorithms: none on a pristine
    stream's full or cached frame, the reach BFS on a delta frame, inside
    ``latency_s``."""
    g, filt, _, f0 = grid_setting
    lane = StreamingFilter(filt, backend="dense", device="cpu")
    r0, r1 = lane.push(f0), lane.push(f0)
    r2 = lane.push(_patch_frame(f0, 10, 10))
    assert (r0.mode, r1.mode, r2.mode) == ("full", "cached", "delta")
    assert r0.host_s == 0.0 and r1.host_s == 0.0
    assert 0.0 < r2.host_s <= r2.latency_s



def test_streaming_refresh_every_and_atol(grid_setting):
    g, filt, jfilt, f0 = grid_setting
    frames = [f0] + [_patch_frame(f0, 4 + t, 4 + t) for t in range(3)]
    lane = StreamingFilter(filt, backend="dense", refresh_every=2, device="cpu")
    assert [lane.push(y).mode for y in frames] == ["full", "delta", "full", "delta"]
    # a change below atol is served from the cache
    lane = StreamingFilter(filt, backend="dense", atol=0.6, device="cpu")
    jlane = JStream(jfilt, backend="dense", atol=0.6)
    for y in frames[:2] + [_patch_frame(f0, 20, 20, bump=1.0)]:
        _same_record(lane.push(y), jlane.push(y))


def test_streaming_shape_change_resets(grid_setting):
    g, filt, _, f0 = grid_setting
    lane = StreamingFilter(filt, backend="dense", device="cpu")
    lane.push(f0)
    panel = np.stack([f0, f0 + 1.0], axis=1)
    res = lane.push(panel)
    assert res.mode == "full"
    np.testing.assert_allclose(res.out.numpy(), _full(filt, panel), atol=1e-5)


def test_streaming_refuses_another_device(grid_setting):
    _, filt, _, f0 = grid_setting
    lane = StreamingFilter(filt, backend="dense", device="cpu")
    with pytest.raises(ValueError, match="stream on cpu"):
        lane.push(torch.as_tensor(f0, device="meta"))
    with pytest.raises(ValueError, match="graph is on cpu"):
        StreamingFilter(filt, device="meta")


# ---- words accounting --------------------------------------------------------


def test_vertex_send_counts_and_full_support_words(grid_setting):
    g, _, _, _ = grid_setting
    plan = tdist.build_partition_plan(g.adjacency, g.coords, 4, device="cpu")
    jplan = jdist.build_partition_plan(jgraph.grid_graph(SIDE).adjacency,
                                       jgraph.grid_graph(SIDE).coords, 4)
    counts = plan.vertex_send_counts(g.adjacency)
    assert int(counts.sum()) == plan.halo_words == jplan.halo_words
    full = np.ones(g.n_vertices, bool)
    assert plan.delta_halo_words(g.adjacency, full, ORDER) == ORDER * plan.halo_words


def test_delta_words_scale_with_boundary_of_change(grid_setting):
    """At <= 10% changed vertices the delta path exchanges fewer words per
    frame than a full refilter; the lane's accounting equals the plan
    model and the reference lane's."""
    g, filt, jfilt, f0 = grid_setting
    lane = StreamingFilter(filt, backend="dense", n_parts=4, device="cpu")
    jlane = JStream(jfilt, backend="dense", n_parts=4)
    full_words = ORDER * lane._plan.halo_words
    y = _patch_frame(f0, 12, 12, patch=5)
    for frame in (f0, y):
        res = lane.push(frame)
        _same_record(res, jlane.push(frame))
    assert res.mode == "delta" and 0 < res.words < full_words
    changed = y != f0
    assert res.words == lane._plan.delta_halo_words(g.adjacency, changed, ORDER)
    lane.reset()
    jlane.reset()
    for frame in (f0, _patch_frame(f0, 10, 10, patch=10)):
        res2 = lane.push(frame)
        _same_record(res2, jlane.push(frame))
    assert res2.mode == "delta" and res2.words >= res.words


def test_streaming_filter_without_plan_reports_zero_words(grid_setting):
    _, filt, _, f0 = grid_setting
    lane = StreamingFilter(filt, backend="dense", device="cpu")
    assert lane.push(f0).words == 0
    assert lane.push(_patch_frame(f0, 3, 3)).words == 0


def test_tab_streaming_cell_matches_the_record():
    """``benchmarks/run.py``'s ``tab_streaming`` delta rows at their own
    shape (80 x 80 grid, Tikhonov M = 20, lmax 8, 8 parts): words, modes,
    changed and active as ``BENCH_pr10.json`` records them, and parity
    with the full refilter within 1e-5."""
    side = 80
    g = tgraph.grid_graph(side, device="cpu")
    filt = GraphFilter.from_multipliers([tmult.tikhonov(1.0, 1)], 20, graph=g, lmax=8.0)
    f0 = (g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2).numpy()
    lane = StreamingFilter(filt, backend="dense", n_parts=8, max_delta_frac=0.5, device="cpu")
    assert lane.push(f0).words == lane._full_words() == 12800
    record = {11: (121, 1269, 1030), 18: (324, 2414, 3678), 25: (625, 2333, 2855),
              40: (1600, 4806, 8181)}
    rng = np.random.default_rng(11)
    for patch, want in record.items():
        y = f0.copy()
        r0, c0 = rng.integers(0, side - patch, size=2)
        rr, cc = np.meshgrid(np.arange(r0, r0 + patch), np.arange(c0, c0 + patch),
                             indexing="ij")
        ch = (rr * side + cc).ravel()
        y[ch] += rng.normal(size=len(ch)).astype(np.float32) * 0.3
        lane.reset()
        lane.push(f0)
        res = lane.push(y)
        assert res.mode == "delta" and (res.changed, res.active, res.words) == want
        np.testing.assert_allclose(res.out.numpy(), _full(filt, y), atol=1e-5)


# ---- warm starts ---------------------------------------------------------------


def _first_hit(history, target):
    hit = np.nonzero(np.asarray(history) <= target)[0]
    return int(hit[0]) if hit.size else None


@pytest.mark.parametrize("method,budget", [("ista", 120), ("fista", 80)])
def test_warm_start_lasso(sensor_setting, method, budget):
    """Seeded with frame 0's solution, the frame 1 solve crosses the cold
    run's final objective within budget/4, at the iteration the live
    reference does."""
    _, _, filt, jfilt, y0, y1 = sensor_setting
    solve, jsolve = {"ista": (ista, jista), "fista": (fista, jfista)}[method]
    p0, p1 = (LassoProblem(filt=filt, y=torch.as_tensor(y), mu=2.0) for y in (y0, y1))
    j0, j1 = (JLasso(filt=jfilt, y=jnp.asarray(y), mu=2.0) for y in (y0, y1))
    cold0, cold1 = solve(p0, n_iters=budget), solve(p1, n_iters=budget)
    warm1 = solve(p1, a0=cold0.aux, n_iters=budget)
    jcold0, jcold1 = jsolve(j0, n_iters=budget), jsolve(j1, n_iters=budget)
    jwarm1 = jsolve(j1, a0=jcold0.aux, n_iters=budget)
    hit = _first_hit(warm1.history, float(cold1.history[-1]) * (1.0 + 1e-6))
    assert hit is not None and hit <= budget // 4
    assert hit == _first_hit(jwarm1.history, float(jcold1.history[-1]) * (1.0 + 1e-6))
    assert p1.objective(warm1.aux) <= p1.objective(cold1.aux) * (1 + 1e-4)


def test_warm_start_cg_fewer_iterations(sensor_setting):
    _, _, filt, jfilt, y0, y1 = sensor_setting
    prob0, prob1 = (GramProblem(filt=filt, b=torch.as_tensor(y), reg=0.5) for y in (y0, y1))
    r0 = conjugate_gradient(prob0, n_iters=200, tol=1e-7)
    cold = conjugate_gradient(prob1, n_iters=200, tol=1e-7)
    warm = conjugate_gradient(prob1, x0=r0.x, n_iters=200, tol=1e-7)
    assert warm.converged and cold.converged and warm.iterations < cold.iterations
    np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), rtol=1e-3, atol=1e-4)
    jprob0, jprob1 = (JGram(filt=jfilt, b=jnp.asarray(y), reg=0.5) for y in (y0, y1))
    jr0 = jcg(jprob0, n_iters=200, tol=1e-7)
    assert (cold.iterations, warm.iterations) == (
        jcg(jprob1, n_iters=200, tol=1e-7).iterations,
        jcg(jprob1, x0=jr0.x, n_iters=200, tol=1e-7).iterations)


def test_streaming_lasso_and_wiener_lanes(sensor_setting):
    g, jg, filt, jfilt, y0, y1 = sensor_setting
    lane = StreamingLasso(filt, mu=2.0, tol=1e-4, n_iters=150, device="cpu")
    jlane = JStreamingLasso(jfilt, mu=2.0, tol=1e-4, n_iters=150)
    r0, r1 = lane.push(y0), lane.push(y1)
    assert r1.iterations <= r0.iterations
    assert [r0.iterations, r1.iterations] == [jlane.push(y0).iterations,
                                              jlane.push(y1).iterations]
    p1 = LassoProblem(filt=filt, y=torch.as_tensor(y1), mu=2.0)
    assert p1.objective(r1.aux) <= p1.objective(fista(p1, n_iters=150).aux) * 1.10
    heat = GraphFilter.from_multipliers([tmult.heat(0.5)], 16, graph=g)
    jheat = JFilter.from_multipliers([jmult.heat(0.5)], 16, graph=jg)
    wlane = StreamingWiener(heat, 0.25, tol=1e-6, n_iters=200, device="cpu")
    jwlane = JStreamingWiener(jheat, 0.25, tol=1e-6, n_iters=200)
    w0, w1 = wlane.push(y0), wlane.push(y1)
    assert w0.converged and w1.converged and w1.iterations <= w0.iterations
    assert [w0.iterations, w1.iterations] == [jwlane.push(y0).iterations,
                                              jwlane.push(y1).iterations]


def test_stream_convenience_functions(sensor_setting):
    g, _, filt, _, y0, y1 = sensor_setting
    res_i = stream_ista(filt, [y0, y1], mu=2.0, tol=1e-4, n_iters=60, device="cpu")
    res_f = stream_fista(filt, [y0, y1], mu=2.0, tol=1e-4, n_iters=60, device="cpu")
    assert len(res_i) == len(res_f) == 2
    assert {r.method for r in res_i} == {"ista"} and {r.method for r in res_f} == {"fista"}
    heat = GraphFilter.from_multipliers([tmult.heat(0.5)], 16, graph=g)
    res_w = stream_wiener(heat, [y0, y1], 0.25, tol=1e-6, n_iters=200, device="cpu")
    assert [r.method for r in res_w] == ["wiener", "wiener"]
    assert res_w[1].iterations <= res_w[0].iterations


def test_streaming_lasso_rejects_unknown_method(sensor_setting):
    _, _, filt, _, _, _ = sensor_setting
    with pytest.raises(ValueError, match="ista"):
        StreamingLasso(filt, method="bogus", device="cpu")


# ---- apps/streaming ------------------------------------------------------------


def test_streaming_apps_match_reference(sensor_setting):
    g, jg, _, _, y0, y1 = sensor_setting
    frames = [y0, y1, y1]
    out, results = streaming_denoise(g, frames, order=12, n_parts=4, device="cpu")
    jout, jresults = jstreaming_denoise(jg, frames, order=12, n_parts=4)
    assert out.shape == (3, 96) and out.device == g.device
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    for res, ref in zip(results, jresults):
        _same_record(res, ref)
    est, sres = streaming_wavelet_denoise(g, frames[:2], n_scales=3, order=12, mu=2.0,
                                          n_iters=60, device="cpu")
    jest, jsres = jstreaming_wavelet(jg, frames[:2], n_scales=3, order=12, mu=2.0, n_iters=60)
    assert [r.iterations for r in sres] == [r.iterations for r in jsres]
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), atol=1e-4)


# ---- the streaming example as a port module ---------------------------------


def test_streaming_denoising_example_runs_on_cpu():
    from repro_torch import streaming_denoising

    res = streaming_denoising.main(device="cpu")
    assert res["max_err"] < 1e-5  # every frame against the full refilter
    assert res["delta_frames"] >= 5  # the delta path engaged after the first frame
    assert [r[0] for r in res["records"]] == ["full"] + ["delta"] * 5
    assert all(r[1] == 81 for r in res["records"][1:])  # one 9 x 9 patch per frame
    assert res["engine_frames"] == list(range(6))
    assert res["warm_iters"][-1] <= res["cold_iters"]
