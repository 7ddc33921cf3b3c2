"""Port parity for topology churn: ``repro_torch.dynamic``,
``lmax_power_iteration``, ``repair_partition_plan`` and the churn paths of
``repro_torch.stream.StreamingFilter``, case for case with
``tests/test_dynamic.py`` and held against the live reference on the same
numpy inputs.

* Deltas, in-place patches, tracker bounds, scenarios and repaired plans
  equal the reference's bit for bit.
* ``lmax_power_iteration`` meets the reference's own surface test; with an
  explicit ``v0`` it agrees with the reference within 1e-5 relative (the
  default starts differ by design).
* Churn streams: modes, words, ``changed``, ``active`` and re-expansions
  equal the reference lane's, and every output is within 1e-5 of the
  reference's ``_churn_oracle`` (a dense refilter of the evolved graph
  with the lane's own coefficients and ``lmax``).
* ``kernel_trace_counts()`` adds no key on a replayed scenario.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chebyshev as jcheb
from repro.core import distributed as jdist
from repro.core import graph as jgraph
from repro.dynamic import GraphDelta as JDelta
from repro.dynamic import LmaxTracker as JTracker
from repro.dynamic import apply_delta_inplace as japply_inplace
from repro.dynamic import apply_graph_delta as japply_graph
from repro.dynamic import mobile_sensor_scenario as jscenario
from repro.filters import GraphFilter as JFilter
from repro.stream import StreamingFilter as JStream
from repro_torch import interop
from repro_torch.core import collectives
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.core.graph import is_connected, khop_neighborhood, lmax_power_iteration
from repro_torch.dynamic import (
    GraphDelta,
    LmaxTracker,
    apply_delta_inplace,
    apply_graph_delta,
    churn_correction,
    dense_cheb_apply_krylov,
    kernel_trace_counts,
    mobile_sensor_scenario,
)
from repro_torch.filters import GraphFilter
from repro_torch.stream import StreamingFilter

try:
    import hypothesis
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - dev dep
    hypothesis = None
    st = None

needs_hypothesis = pytest.mark.skipif(hypothesis is None, reason="hypothesis not installed")


def _random_graph(n: int, seed: int):
    """Connected weighted random graph + coords (ER edges over a ring), as
    ``tests/test_dynamic.py`` draws it."""
    rng = np.random.default_rng(seed)
    a = (rng.uniform(size=(n, n)) < 0.12).astype(np.float64)
    a = np.triu(a, 1)
    idx = np.arange(n)
    a[idx[:-1], idx[1:]] = 1.0
    a[0, n - 1] = 1.0
    a = a * rng.uniform(0.5, 1.5, size=a.shape)
    a = a + a.T
    coords = rng.uniform(size=(n, 2))
    return a, coords


def _random_delta(a: np.ndarray, rng, k: int = 4) -> GraphDelta:
    """Mixed remove/reweight/add batch drawn from the current adjacency."""
    n = a.shape[0]
    uu, vv = np.nonzero(np.triu(a, 1))
    edges = []
    for _ in range(k):
        kind = rng.integers(3)
        if kind < 2 and uu.size:
            j = rng.integers(uu.size)
            w = 0.0 if kind == 0 else float(rng.uniform(0.5, 1.5))
            edges.append((int(uu[j]), int(vv[j]), w))
        else:
            u, v = rng.integers(n), rng.integers(n)
            if u != v:
                edges.append((int(u), int(v), float(rng.uniform(0.5, 1.5))))
    return GraphDelta(tuple(edges))


def _jdelta(d: GraphDelta) -> JDelta:
    return JDelta(d.edges, d.coords)


# ---- GraphDelta and the in-place patch -------------------------------------


def test_graph_delta_canonicalization():
    raw = ((3, 1, 0.5), (1, 3, 0.7), (2, 2, 9.0), (4, 0, 0.0))
    d = GraphDelta(raw)
    assert d.edges == ((0, 4, 0.0), (1, 3, 0.7)) == JDelta(raw).edges
    assert len(d) == 2
    assert d.touched.tolist() == [0, 1, 3, 4]
    assert np.array_equal(d.touched, JDelta(raw).touched)
    assert GraphDelta(()).touched.size == 0


def test_vertex_leave_and_join_slot_pool():
    a, coords = _random_graph(20, 0)
    g = interop.sensor_graph_from_numpy(a, coords, "cpu")
    jg = jgraph.SensorGraph(jnp.asarray(a, jnp.float32), jnp.asarray(coords, jnp.float32))
    v = 7
    leave = GraphDelta.vertex_leave(a, v)
    assert leave.edges == JDelta.vertex_leave(a, v).edges
    assert GraphDelta.vertex_leave(g.adjacency, v).edges == leave.edges
    g2 = apply_graph_delta(g, leave)
    jg2 = japply_graph(jg, _jdelta(leave))
    a2 = g2.adjacency.numpy()
    assert g2.device == g.device and a2.shape == a.shape
    assert np.array_equal(a2, np.asarray(jg2.adjacency))
    assert not a2[v].any() and not a2[:, v].any()
    join = GraphDelta.vertex_join(v, [1, 2, 3], weights=[0.5, 0.6, 0.7])
    assert join.edges == JDelta.vertex_join(v, [1, 2, 3], weights=[0.5, 0.6, 0.7]).edges
    a3 = apply_graph_delta(g2, join).adjacency.numpy()
    assert np.array_equal(a3, np.asarray(japply_graph(jg2, _jdelta(join)).adjacency))
    assert a3[v, 1] == pytest.approx(0.5) and a3[3, v] == pytest.approx(0.7)
    moved = GraphDelta((), coords=coords + 0.1)
    assert np.array_equal(apply_graph_delta(g, moved).coords.numpy(),
                          np.asarray(japply_graph(jg, _jdelta(moved)).coords))


def test_apply_delta_functional_vs_inplace():
    a, coords = _random_graph(40, 1)
    a = a.astype(np.float32)
    g = interop.sensor_graph_from_numpy(a, coords, "cpu")
    uu, vv = np.nonzero(np.triu(a, 1))
    u0, v0 = int(uu[0]), int(vv[0])
    d = GraphDelta((
        (u0, v0, 0.0),
        (int(uu[1]), int(vv[1]), 2.0),
        (0, a.shape[0] - 2, 1.25),
        (int(uu[2]), int(vv[2]), float(a[uu[2], vv[2]])),  # no-op
    ))
    want = apply_graph_delta(g, d).adjacency.numpy()
    adj, lap = a.copy(), np.diag(a.sum(axis=1)) - a
    touched, changed = apply_delta_inplace(adj, lap, d)
    jadj, jlap = a.copy(), np.diag(a.sum(axis=1)) - a
    jtouched, jchanged = japply_inplace(jadj, jlap, _jdelta(d))
    assert np.array_equal(adj, want) and np.array_equal(adj, jadj)
    assert np.array_equal(lap, jlap) and np.array_equal(touched, jtouched)
    assert changed == jchanged and len(changed) == 3
    np.testing.assert_allclose(lap, np.diag(adj.sum(axis=1)) - adj, atol=1e-5)
    assert (int(uu[2]), int(vv[2])) not in {(u, v) for u, v, _ in changed}


# ---- LmaxTracker and lmax_power_iteration ----------------------------------


def test_lmax_tracker_certified_invariant():
    a, _ = _random_graph(60, 2)
    tracker, jtracker = LmaxTracker(a), JTracker(a)
    rng = np.random.default_rng(3)
    adj = a.copy()
    prev_bound = tracker.bound
    for _ in range(6):
        d = _random_delta(adj, rng)
        _, changed = apply_delta_inplace(adj, None, d)
        b = tracker.update(adj, changed)
        assert b == jtracker.update(adj, changed)  # the host numpy, bit for bit
        lam = float(np.linalg.eigvalsh(np.diag(adj.sum(axis=1)) - adj).max())
        assert b >= lam and b >= prev_bound
        prev_bound = b
    lam = float(np.linalg.eigvalsh(np.diag(adj.sum(axis=1)) - adj).max())
    b_exact = tracker.recertify(adj)
    assert b_exact == jtracker.recertify(adj)
    assert lam <= b_exact <= prev_bound and tracker.recertifications == 1
    lap = np.diag(adj.sum(axis=1)) - adj
    fresh = LmaxTracker(adj)  # the port's own default start
    b_default = fresh.power_estimate(lap, iters=200)
    assert b_default <= fresh.recertify(adj) and b_default >= 0.999 * lam
    assert fresh._v is not None
    # the default starts differ by design: from one warm start the port's
    # decision is the reference's
    tracker._v = jtracker._v = np.random.default_rng(8).normal(size=60).astype(np.float32)
    b_pow = tracker.power_estimate(lap, iters=200)
    assert b_pow <= b_exact and b_pow >= 0.999 * lam
    assert b_pow == pytest.approx(jtracker.power_estimate(lap, iters=200), rel=1e-5)
    assert tracker.method == jtracker.method == "power"


@pytest.mark.parametrize("as_tensor", [False, True])
def test_power_estimate_runs_on_the_laplacians_device(as_tensor):
    """A tensor Laplacian (a churn stream's device copy) gives the host
    array's estimate bit for bit, and the warm-start iterate stays on the
    matrix's device."""
    a, _ = _random_graph(50, 4)
    lap = np.diag(a.sum(axis=1)) - a
    v0 = np.random.default_rng(8).normal(size=50).astype(np.float32)
    host, other = LmaxTracker(a), LmaxTracker(a)
    host._v = other._v = v0
    want = host.power_estimate(lap, iters=120)
    got = other.power_estimate(torch.as_tensor(lap) if as_tensor else lap, iters=120)
    assert got == want
    assert isinstance(other._v, torch.Tensor) and other._v.device.type == "cpu"
    assert torch.equal(other._v, host._v)



def test_lmax_power_iteration_surface():
    a, _ = _random_graph(50, 4)
    lap32 = (np.diag(a.sum(axis=1)) - a).astype(np.float32)
    lap = torch.as_tensor(lap32)
    lam = float(np.linalg.eigvalsh(lap32.astype(np.float64)).max())
    e1 = float(lmax_power_iteration(lap, 60))
    e2 = float(lmax_power_iteration(lap, 60))
    assert e1 == e2
    assert 0.99 * lam <= e1 <= 1.05 * lam
    est, v = lmax_power_iteration(lap, 60, return_vector=True)
    assert v.shape == (lap.shape[0],)
    e_warm = float(lmax_power_iteration(lap, 3, v0=v))
    assert abs(e_warm - float(est)) < 1e-3 * lam
    e3 = float(lmax_power_iteration(lap, 200, seed=5))
    assert abs(e3 - e1) < 5e-3 * lam
    # from the same explicit start, the port follows the reference
    v0 = np.random.default_rng(9).normal(size=lap.shape[0]).astype(np.float32)
    for iters in (5, 60):
        want = float(jgraph.lmax_power_iteration(jnp.asarray(lap32), iters, v0=jnp.asarray(v0)))
        assert float(lmax_power_iteration(lap, iters, v0=v0)) == pytest.approx(want, rel=1e-5)


# ---- khop / connectivity with churn ----------------------------------------


def test_khop_neighborhood_with_isolated_vertices():
    a, _ = _random_graph(30, 5)
    v = 11
    adj = a.copy()
    apply_delta_inplace(adj, None, GraphDelta.vertex_leave(a, v))
    others = np.ones(30, dtype=bool)
    others[v] = False
    assert not khop_neighborhood(adj, others, 30)[v]
    mask = khop_neighborhood(adj, np.asarray([v]), 3)
    assert mask[v] and mask.sum() == 1
    assert np.array_equal(mask, jgraph.khop_neighborhood(adj, np.asarray([v]), 3))
    assert khop_neighborhood(adj, np.asarray([0]), 0).sum() == 1


def test_is_connected_ignore_isolated():
    a, _ = _random_graph(30, 6)
    assert is_connected(a) and is_connected(a, ignore_isolated=True)
    adj = a.copy()
    apply_delta_inplace(adj, None, GraphDelta.vertex_leave(a, 0))
    assert not is_connected(adj)
    assert is_connected(adj, ignore_isolated=True)
    empty = np.zeros((5, 5))
    assert not is_connected(empty) and is_connected(empty, ignore_isolated=True)


# ---- plan repair, bit for bit ----------------------------------------------


def _assert_plans_equal(got, want):
    for name in ("order", "boundary_counts", "pair_counts"):
        assert np.array_equal(getattr(got, name), np.asarray(getattr(want, name))), name
    for name in ("n_boundary", "halo_words", "n_local", "n", "n_parts"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("l_own", "l_halo", "send_idx"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name


def _check_repaired_plan(plan, a):
    """The overlap invariants of ``tests/test_dynamic.py``, on the port's plan."""
    n, n_local = plan.n, plan.n_local
    n_pad = n_local * plan.n_parts
    lap_full = np.diag(a.sum(axis=1)) - a
    lap = np.zeros((n_pad, n_pad))
    lap[:n, :n] = lap_full[np.ix_(plan.order, plan.order)]
    counts = plan.boundary_counts
    l_halo, send_idx = plan.l_halo.numpy(), plan.send_idx.numpy()
    assert sorted(plan.order.tolist()) == list(range(n))
    assert plan.n_boundary >= max(1, counts.max())
    for p in range(plan.n_parts):
        sl = slice(p * n_local, (p + 1) * n_local)
        off = np.ones(n_pad, dtype=bool)
        off[sl] = False
        is_boundary = np.any(lap[sl][:, off] != 0.0, axis=1)
        assert is_boundary[: counts[p]].all() and not is_boundary[counts[p]:].any()
        for q in range(plan.n_parts):
            if q != p:
                used = np.any(l_halo[p][:, q * plan.max_halo : (q + 1) * plan.max_halo] != 0.0,
                              axis=0)
                assert np.all(send_idx[q, p][used] < counts[q])
                assert int(used.sum()) <= int(plan.pair_counts[p, q])
    rows = tdist.plan_row_slabs(plan).numpy()
    assert np.max(np.abs(rows - lap.reshape(plan.n_parts, n_local, n_pad))) < 2e-6


def _repair_run(a, coords, n_parts, rng, steps, k=4, check=True):
    """Repair port and reference plans through the same deltas, holding
    them equal after every step; returns both final plans and the count."""
    plan = tdist.build_partition_plan(a, coords, n_parts, device="cpu")
    jplan = jdist.build_partition_plan(a, coords, n_parts)
    repaired = 0
    for _ in range(steps):
        touched, _ = apply_delta_inplace(a, None, _random_delta(a, rng, k))
        if touched.size == 0:
            continue
        plan = tdist.repair_partition_plan(plan, a, touched)
        jplan = jdist.repair_partition_plan(jplan, a, touched)
        repaired += 1
        _assert_plans_equal(plan, jplan)
        if check:
            _check_repaired_plan(plan, a)
            assert plan.halo_words == tdist.build_partition_plan(
                a, coords, n_parts, device="cpu").halo_words
            assert int(plan.pair_counts.sum()) == plan.halo_words
    return plan, jplan, repaired


@pytest.mark.parametrize("n,n_parts,seed", [(48, 2, 0), (90, 4, 1), (120, 8, 2)])
def test_repair_sequential_deltas(n, n_parts, seed):
    a, coords = _random_graph(n, seed)
    a = a.astype(np.float32).astype(np.float64)
    _, _, repaired = _repair_run(a, coords, n_parts, np.random.default_rng(seed + 100), 6)
    assert repaired >= 4


def test_repair_empty_touched_is_identity():
    a, coords = _random_graph(40, 9)
    plan = tdist.build_partition_plan(a, coords, 4, device="cpu")
    assert tdist.repair_partition_plan(plan, a, np.zeros(0, np.int64)) is plan
    with pytest.raises(ValueError, match="boundary_counts"):
        tdist.repair_partition_plan(dataclasses.replace(plan, boundary_counts=None), a, [0, 1])


def test_repair_grows_lanes_like_the_reference():
    """A delta that wires one vertex to many vertices of another partition
    outgrows ``max_halo``: both packages grow the lanes the same way, and
    a plan without ``pair_counts`` recovers them from the tables."""
    n = 64
    angle = 2 * np.pi * np.arange(n) / n
    coords = np.stack([np.cos(angle), np.sin(angle)], axis=1)
    a = np.zeros((n, n))
    a[np.arange(n), (np.arange(n) + 1) % n] = 1.0
    a = a + a.T  # a ring: every partition is an arc with one lane per side
    plan = tdist.build_partition_plan(a, coords, 4, device="cpu")
    jplan = jdist.build_partition_plan(a, coords, 4)
    owner = plan.owner_of()
    far = np.nonzero(owner == (owner[0] + 2) % 4)[0]
    d = GraphDelta(tuple((0, int(v), 0.9) for v in far))
    touched, _ = apply_delta_inplace(a, None, d)
    got = tdist.repair_partition_plan(plan, a, touched)
    assert got.max_halo > plan.max_halo
    _assert_plans_equal(got, jdist.repair_partition_plan(jplan, a, touched))
    legacy = tdist.repair_partition_plan(dataclasses.replace(plan, pair_counts=None), a, touched)
    _assert_plans_equal(legacy, jdist.repair_partition_plan(
        dataclasses.replace(jplan, pair_counts=None), a, touched))
    _check_repaired_plan(got, a)


@needs_hypothesis
def test_repair_invariants_random():
    @hypothesis.settings(max_examples=6, deadline=None)
    @hypothesis.given(
        n=st.integers(24, 80),
        n_parts=st.sampled_from([2, 3, 4]),
        seed=st.integers(0, 2**30),
    )
    def run(n, n_parts, seed):
        a, coords = _random_graph(n, seed)
        _repair_run(a, coords, n_parts, np.random.default_rng(seed), 3)

    run()


@pytest.mark.parametrize("n,n_parts,order,seed", [(90, 4, 12, 20), (200, 8, 16, 0)])
def test_repaired_plan_halo_parity(n, n_parts, order, seed):
    """The repaired plan runs both halo schedules unchanged (exactly M
    exchanges) and matches the reference's dense oracle on the evolved
    graph within 1e-5. The (200, 8) case is the reference's 8-device
    subprocess test, run in-process on ``StackedMesh(8)``."""
    a, coords = _random_graph(n, seed)
    rng = np.random.default_rng(seed + 1)
    plan, _, _ = _repair_run(a, coords, n_parts, rng, 4, k=5, check=False)
    lap = np.diag(a.sum(axis=1)) - a
    lmax = float(np.linalg.eigvalsh(lap).max()) * 1.01
    coeffs = np.asarray(jcheb.cheb_coefficients(
        [lambda x: np.exp(-x), lambda x: x / (1.0 + x)], order, lmax), np.float32)
    f = rng.normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(jcheb.cheb_apply_dense(jnp.asarray(lap, jnp.float32), jnp.asarray(f),
                                             jnp.asarray(coeffs), lmax))
    mesh = collectives.StackedMesh(n_parts, "cpu")
    ctx = tdist.DistributedGraphContext(plan=plan, mesh=mesh)
    sharded = ctx.scatter_signal(torch.as_tensor(f))
    for overlap in (True, False):
        mesh.reset_counts()
        got = ctx.gather_signal(ctx.cheb_apply(sharded, coeffs, lmax, overlap=overlap))
        assert mesh.calls["all_to_all"] == order
        assert np.max(np.abs(got.numpy() - want)) < 1e-5, overlap


# ---- scenarios ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_slots=96, n_frames=7, mobility="waypoint", seed=1),
    dict(n_slots=200, n_frames=5, mobility="convoy", seed=7, cluster_radius=0.08, speed=0.02,
         birth_rate=0.3, death_rate=0.3, bump_radius=0.15, k=5, sigma=0.05),
])
def test_scenario_matches_reference_bitwise(kw):
    sc = mobile_sensor_scenario(device="cpu", **kw)
    want = jscenario(**kw)
    assert sc.graph0.device == torch.device("cpu")
    assert np.array_equal(sc.graph0.adjacency.numpy(), np.asarray(want.graph0.adjacency))
    assert np.array_equal(sc.graph0.coords.numpy(), np.asarray(want.graph0.coords))
    assert sc.mean_churn == want.mean_churn
    for got, ref in zip(sc.frames, want.frames, strict=True):
        assert np.array_equal(got.signal, ref.signal)
        assert (got.n_active, got.edges_changed, got.churn_fraction) == (
            ref.n_active, ref.edges_changed, ref.churn_fraction)
        if ref.delta is None:
            assert got.delta is None
        else:
            assert got.delta.edges == ref.delta.edges
            assert np.array_equal(got.delta.coords, ref.delta.coords)
    with pytest.raises(ValueError, match="mobility"):
        mobile_sensor_scenario(8, 2, mobility="teleport", device="cpu")


# ---- streaming churn ---------------------------------------------------------


def _churn_oracle(lane, cur_adj: np.ndarray, signal):
    """The reference's ``_churn_oracle``: a from-scratch dense refilter of
    the evolved graph with the lane's own certified coefficients."""
    c = lane._coeffs if lane._coeffs is not None else np.atleast_2d(lane.filt.coeffs)
    lm = lane._lmax if lane._lmax is not None else lane.filt.lmax
    g = jgraph.SensorGraph(jnp.asarray(cur_adj, jnp.float32))
    return np.asarray(jcheb.cheb_apply_dense(g.laplacian(), np.asarray(signal),
                                             np.asarray(c, np.float32), lm))


def _run_lanes(g0_adj, coords, bank, order, lmax, steps, *, n_parts=None, tol=1e-5):
    """Push ``(signal, delta)`` steps through a port lane and a reference
    lane side by side: equal records, and every port output within
    ``tol`` of the churn oracle. Returns the port lane and its modes."""
    g = interop.sensor_graph_from_numpy(g0_adj, coords, "cpu")
    jg = jgraph.SensorGraph(jnp.asarray(g0_adj, jnp.float32),
                            None if coords is None else jnp.asarray(coords, jnp.float32))
    filt = GraphFilter.from_multipliers(bank, order, graph=g, lmax=lmax)
    lane = StreamingFilter(filt, backend="dense", max_delta_frac=0.9, n_parts=n_parts,
                           device="cpu")
    jlane = JStream(JFilter.from_multipliers(bank, order, graph=jg, lmax=lmax), backend="dense",
                    max_delta_frac=0.9, n_parts=n_parts)
    cur = np.array(g0_adj, np.float32)
    modes = []
    for signal, delta in steps:
        res = lane.push(signal, delta=delta)
        ref = jlane.push(signal, delta=None if delta is None else _jdelta(delta))
        assert (res.mode, res.changed, res.active, res.words, res.edges_changed) == (
            ref.mode, ref.changed, ref.active, ref.words, ref.edges_changed)
        assert isinstance(res.out, torch.Tensor) and res.out.device == g.device
        if delta is not None:
            for u, v, w in delta.edges:
                cur[u, v] = cur[v, u] = w
        err = float(np.max(np.abs(res.out.numpy() - _churn_oracle(lane, cur, signal))))
        assert err < tol, (res.mode, err)
        modes.append(res.mode)
    assert (lane.reexpansions, lane.recertifications, lane.graph_version) == (
        jlane.reexpansions, jlane.recertifications, jlane.graph_version)
    # the shared filter was never mutated
    assert np.array_equal(filt.graph.adjacency.numpy(), np.asarray(g0_adj, np.float32))
    return lane, modes


_BANK = [lambda x: 1.0 / (1.0 + x), lambda x: np.exp(-0.5 * x)]


@pytest.mark.parametrize("kw,n_parts", [
    (dict(n_slots=96, n_frames=7, mobility="waypoint", seed=1), None),
    (dict(n_slots=500, n_frames=8, mobility="convoy", seed=7, cluster_radius=0.08,
          speed=0.02, birth_rate=0.3, death_rate=0.3, bump_radius=0.15), 4),
])
def test_streaming_churn_parity_scenarios(kw, n_parts):
    """The waypoint and convoy cases of ``tests/test_dynamic.py``; at 500
    slots the incremental churn path engages and stays exact."""
    sc = mobile_sensor_scenario(device="cpu", **kw)
    a0 = sc.graph0.adjacency.numpy()
    lane, modes = _run_lanes(a0, sc.graph0.coords.numpy(), _BANK, 6,
                             1.5 * float(sc.graph0.lmax_bound()),
                             [(fr.signal, fr.delta) for fr in sc.frames], n_parts=n_parts)
    assert lane.graph_version > 0 and lane.churn_frames > 0
    if kw["n_slots"] == 500:
        assert "churn" in modes and lane.reexpansions == 0
        assert lane._tk.device == lane.device and lane._lap_dev.device == lane.device


def _sensor_graph_80(seed):
    g = jgraph.connected_sensor_graph(jax.random.PRNGKey(seed), n=80, kappa=0.3, sigma=0.25)
    return np.asarray(g.adjacency, np.float32), np.asarray(g.coords)


def test_streaming_churn_explicit_delta_kinds():
    """Edge add / remove / reweight and vertex leave / join, one per frame."""
    a, coords = _sensor_graph_80(2)
    rng = np.random.default_rng(3)
    uu, vv = np.nonzero(np.triu(a, 1))
    deltas = [
        None,
        GraphDelta(((int(uu[0]), int(vv[0]), 0.0),)),
        GraphDelta(((int(uu[1]), int(vv[1]), 2.0),)),
        GraphDelta(((0, 40, 0.8),)),
        GraphDelta.vertex_leave(a, int(vv[2])),
        GraphDelta.vertex_join(int(vv[2]), [int(uu[2]), 5], weights=0.7),
    ]
    steps = [(rng.normal(size=80).astype(np.float32), d) for d in deltas]
    lane, _ = _run_lanes(a, coords, [lambda x: np.exp(-x)], 6,
                         1.5 * float(jgraph.lmax_upper_bound(jnp.asarray(a))), steps)
    assert lane.graph_version == 5


def test_streaming_signal_delta_while_churn_active():
    """A signal-only sparse frame after topology churn takes the delta
    path on the lane's own Laplacian, on an (N, F) panel."""
    g = tgraph.grid_graph(24, device="cpu")
    a, n = g.adjacency.numpy(), g.n_vertices
    rng = np.random.default_rng(5)
    y0 = rng.normal(size=(n, 2)).astype(np.float32)
    uu, vv = np.nonzero(np.triu(a, 1))
    d = GraphDelta(((int(uu[0]), int(vv[0]), 0.0),))
    y1 = y0.copy()
    y1[n // 2] += 1.0
    lane, modes = _run_lanes(a, g.coords.numpy(), [lambda x: 1.0 / (1.0 + x)], 6,
                             1.5 * float(g.lmax_bound()), [(y0, None), (y0, d), (y1, None)],
                             n_parts=4)
    assert lane._churn and modes == ["full", "full", "delta"]
    assert lane.words_total < 3 * lane._full_words()


def test_streaming_churn_reexpansion_on_lmax_growth():
    """A heavy added edge pushes the certified bound past the domain: the
    lane recertifies, then re-expands its coefficients (uploaded once)."""
    a, coords = _sensor_graph_80(6)
    y = np.random.default_rng(7).normal(size=80).astype(np.float32)
    lmax = float(jgraph.lmax_upper_bound(jnp.asarray(a)))
    d = GraphDelta(((0, 1, 50.0),))
    lane, modes = _run_lanes(a, coords, [lambda x: np.exp(-x)], 6, lmax, [(y, None), (y, d)])
    assert lane.reexpansions == 1 and lane.recertifications >= 1 and lane._lmax > lmax
    assert modes == ["full", "full"]
    assert np.array_equal(lane._coeffs_dev.numpy(), lane._coeffs.astype(np.float32))


def test_churn_correction_matches_reference_kernel():
    """The churn kernels against the reference's on the same operands."""
    from repro.dynamic import churn_correction as jchurn
    from repro.dynamic import dense_cheb_apply_krylov as jdense

    rng = np.random.default_rng(4)
    a, _ = _random_graph(40, 8)
    lap = (np.diag(a.sum(axis=1)) - a).astype(np.float32)
    dlap = np.zeros_like(lap)
    dlap[[3, 7], [7, 3]], dlap[[3, 7], [3, 7]] = -0.4, 0.4
    f = rng.normal(size=(40, 3)).astype(np.float32)
    lmax = 1.05 * float(np.linalg.eigvalsh(lap + dlap).max())
    coeffs = jcheb.cheb_coefficients(_BANK, 7, lmax)
    out, tk = dense_cheb_apply_krylov(torch.as_tensor(lap), torch.as_tensor(f), coeffs, lmax)
    jout, jtk = jdense(jnp.asarray(lap), jnp.asarray(f), jnp.asarray(coeffs, jnp.float32), lmax)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jtk), atol=1e-5)
    corr, ds = churn_correction(torch.as_tensor(lap + dlap), torch.as_tensor(dlap), tk,
                                coeffs, lmax)
    jcorr, jds = jchurn(jnp.asarray(lap + dlap), jnp.asarray(dlap), jtk,
                        jnp.asarray(coeffs, jnp.float32), lmax)
    np.testing.assert_allclose(corr.numpy(), np.asarray(jcorr), atol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=1e-5)
    # the correction is the difference of the two dense refilters
    out_new, _ = dense_cheb_apply_krylov(torch.as_tensor(lap + dlap), torch.as_tensor(f),
                                         coeffs, lmax)
    np.testing.assert_allclose((out + corr).numpy(), out_new.numpy(), atol=1e-5)


def test_churn_kernels_zero_steady_state_retraces():
    """Replaying a whole scenario through a fresh lane after a warm run
    adds no (shape, dtype) key to any churn kernel."""
    sc = mobile_sensor_scenario(256, 6, mobility="convoy", seed=9, cluster_radius=0.1,
                                speed=0.02, birth_rate=0.3, death_rate=0.3, bump_radius=0.15,
                                device="cpu")

    def run_once():
        filt = GraphFilter.from_multipliers([lambda x: 1.0 / (1.0 + x)], 6, graph=sc.graph0,
                                            lmax=1.5 * float(sc.graph0.lmax_bound()))
        lane = StreamingFilter(filt, backend="dense", max_delta_frac=0.9, device="cpu")
        for fr in sc.frames:
            lane.push(fr.signal, delta=fr.delta)

    run_once()
    snap = kernel_trace_counts()
    assert snap.get("dense_cheb_apply_krylov", 0) >= 1
    run_once()
    assert kernel_trace_counts() == snap
