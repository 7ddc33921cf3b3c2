"""Port parity for the serving layer: ``repro_torch.serve`` and
``GraphFilter.panel_program``, case for case with the engine tests of
``tests/test_engine.py`` (all but the load generator's, which is not
ported), ``tests/test_filters.py``, ``tests/test_solvers.py`` and
``tests/test_stream.py``, on the CPU.

The same numpy inputs go through ``repro.serve`` and ``repro_torch.serve``
(graphs carried across with ``interop``): every answer is held to the
reference's solo path at the reference tests' tolerances (1e-5 applies
and frames, 1e-4 solves), and what the reference counts — recompiles,
cache hits, pad waste, evictions and the evicted streams themselves,
admission rejections — must come out equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import graph as jgraph
from repro.core import multipliers as jmult
from repro.dynamic import GraphDelta as JGraphDelta
from repro.filters import GraphFilter as JFilter
from repro.filters import bucket_size as jbucket_size
from repro.serve.engine import _bind_solver_backend as j_bind
from repro.solvers import LassoProblem as JLasso
from repro.solvers import fista as jfista
from repro.solvers import solve as jsolve
from repro.stream import StreamingFilter as JStream
from repro_torch import interop
from repro_torch import serve as tserve
from repro_torch.core import graph as tgraph
from repro_torch.core import multipliers as tmult
from repro_torch.dynamic import GraphDelta
from repro_torch.filters import CudaGraphProgram, GraphFilter, bucket_size
from repro_torch.serve.engine import _bind_solver_backend
from repro_torch.stream import StreamingFilter

ORDER = 8
GRID_SIDE = 32


def _carry(jfilt):
    """The reference filter's graph and coefficients as a CPU port filter."""
    jg = jfilt.graph
    g = interop.sensor_graph_from_numpy(np.asarray(jg.adjacency), np.asarray(jg.coords), "cpu")
    return interop.filter_from_numpy(jfilt.coeffs, jfilt.lmax, g)


@pytest.fixture(scope="module")
def jgraph96():
    return jgraph.connected_sensor_graph(jax.random.PRNGKey(1), n=96, sigma=0.17, kappa=0.18)


@pytest.fixture(scope="module")
def setting(jgraph96):
    """tests/test_engine.py:28-38: the 96-node graph, a 2-multiplier union
    at order 8 and a 16-signal pool, in both packages."""
    jfilt = JFilter.from_multipliers(
        [jmult.tikhonov(1.0, 1), jmult.heat(0.5)], order=ORDER, graph=jgraph96)
    filt = _carry(jfilt)
    # The churn lane re-expands from the bank if a delta pushes lmax out.
    filt = dataclasses.replace(filt, multipliers=(tmult.tikhonov(1.0, 1), tmult.heat(0.5)))
    sigs = np.random.default_rng(3).normal(size=(16, 96)).astype(np.float32)
    return jfilt, filt, sigs


def _ref_solo(jfilt, sig):
    return np.asarray(jfilt.apply(np.asarray(sig), backend="dense"))


def _close(got, want, atol=1e-5, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _ref_fista(jfilt, sig, n_iters=4, mu=1.0):
    return jsolve(JLasso(filt=jfilt, y=np.asarray(sig), mu=mu), method="fista",
                  n_iters=n_iters, backend="dense")


# ------------------------------------------------------ bucket/panel ----


@pytest.mark.parametrize("cap,floor", [(None, 32), (None, 8), (64, 8), (5, 8), (100, 4)])
def test_bucket_size_properties(cap, floor):
    ks = list(range(0, 200))
    assert [bucket_size(k, cap, floor=floor) for k in ks] == [
        jbucket_size(k, cap, floor=floor) for k in ks]
    assert bucket_size(1) == 32
    assert [bucket_size(k, floor=8) for k in (1, 8, 9, 16, 17, 100)] == [8, 8, 16, 16, 32, 128]
    assert bucket_size(100, 64, floor=8) == 64
    vals = [bucket_size(k, floor=8) for k in range(1, 200)]
    assert vals == sorted(vals) and all(v & (v - 1) == 0 for v in vals)


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_apply_panel_bucket_parity(setting, backend):
    jfilt, filt, sigs = setting
    panel = np.asarray(sigs[:5].T)  # (N, 5) -> bucket 8
    got = filt.apply_panel(panel, backend=backend)
    assert tuple(got.shape) == (2, 96, 5)
    _close(got, filt.apply(panel, backend=backend), atol=1e-5)
    _close(got, jfilt.apply_panel(panel, backend="dense"), atol=1e-5)


@pytest.mark.parametrize("backend", ["dense", "bsr", "matvec"])
def test_panel_program_on_the_cpu_is_the_prepared_closure(setting, backend):
    """Off the card a program is the plain prepared closure, as the
    reference's is for a non-traceable backend; it answers like ``apply``."""
    jfilt, filt, sigs = setting
    opts = {}
    if backend == "matvec":
        lap = filt.graph.laplacian()
        opts = {"matvec": lambda v: lap @ v}
    prog = filt.panel_program(backend=backend, donate=True, **opts)
    assert not isinstance(prog, CudaGraphProgram)
    panel = torch.as_tensor(sigs[:8].T.copy())
    out = prog(panel)
    _close(out, filt.apply(panel, backend=backend, **opts), atol=0)
    _close(out, jfilt.panel_program(backend="dense")(np.asarray(panel)), atol=1e-5)
    assert not out.data_ptr() == prog(panel).data_ptr()


# ------------------------------------------------- sync engine parity ----


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_sync_partial_flush_zero_pad_parity(setting, backend):
    jfilt, filt, sigs = setting
    eng = tserve.GraphFilterEngine(filt, backend=backend, panel_width=8, device="cpu")
    for s in sigs[:3]:
        assert eng.submit(s) is None
    outs = eng.flush()
    assert len(outs) == 3 and eng.served == 3 and eng.applies == 1
    for s, out in zip(sigs[:3], outs):
        assert out.device.type == "cpu" and tuple(out.shape) == (2, 96)
        _close(out, filt.apply(np.asarray(s), backend=backend), atol=1e-5)
        _close(out, _ref_solo(jfilt, s), atol=1e-5)


def test_sync_interleaved_lanes_out_of_order_flush(setting):
    jfilt, filt, sigs = setting
    eng = tserve.GraphFilterEngine(
        filt, backend="dense", panel_width=8,
        solver=tserve.lasso_panel_solver(filt, n_iters=4),
        stream_opts={"max_delta_frac": 1.0}, device="cpu")
    eng.submit(sigs[0])
    eng.submit_solve(sigs[1])
    eng.submit_frame("a", sigs[2])
    eng.submit(sigs[3])
    eng.submit_frame("a", sigs[4])
    eng.submit_solve(sigs[5])

    frames = eng.flush_frames()  # out-of-order: frames first
    solves = eng.flush_solves()
    applies = eng.flush()

    for sig, out in zip((sigs[0], sigs[3]), applies):
        _close(out, _ref_solo(jfilt, sig))
    ref = JStream(jfilt, backend="dense", max_delta_frac=1.0)
    for sig, res in zip((sigs[2], sigs[4]), frames):
        _close(res.out, ref.push(np.asarray(sig)).out)
    for sig, res in zip((sigs[1], sigs[5]), solves):
        _close(res.x, _ref_fista(jfilt, sig).x)


def test_graph_filter_engine_batches(jgraph96):
    """tests/test_filters.py:294-314: bsr panels of 4, six requests."""
    jfilt = JFilter.from_multipliers(
        [jmult.tikhonov(1.0, 1), jmult.heat(0.5)], order=16, graph=jgraph96)
    filt = _carry(jfilt)
    eng = tserve.GraphFilterEngine(filt, backend="bsr", panel_width=4, device="cpu")
    signals = [np.random.RandomState(i).randn(96).astype(np.float32) for i in range(6)]
    results = []
    for s in signals:
        got = eng.submit(s)
        if got:
            results.extend(got)
    tail = eng.flush()
    if tail:
        results.extend(tail)
    assert len(results) == 6 and eng.applies == 2 and eng.served == 6
    for s, r in zip(signals, results):
        _close(r, _ref_solo(jfilt, s), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def sgwt_setting(jgraph96):
    """tests/test_solvers.py:33-43: the SGWT lasso bank at order 16."""
    lmax = float(jgraph96.lmax_bound())
    jfilt = JFilter.from_multipliers(
        jmult.sgwt_filter_bank(lmax, n_scales=3), 16, graph=jgraph96, lmax=lmax)
    return jfilt, _carry(jfilt)


def test_solve_as_a_service_panel_parity(sgwt_setting):
    """tests/test_solvers.py:265-290."""
    jfilt, filt = sgwt_setting
    eng = tserve.GraphFilterEngine(
        filt, backend="dense", panel_width=4,
        solver=tserve.lasso_panel_solver(filt, mu=2.0, n_iters=15), device="cpu")
    assert eng.solver.backend == "dense"
    rng = np.random.RandomState(7)
    signals = [rng.randn(96).astype(np.float32) for _ in range(6)]
    results = []
    for s in signals:
        out = eng.submit_solve(s)
        if out:
            results.extend(out)
    tail = eng.flush_solves()
    if tail:
        results.extend(tail)
    assert len(results) == 6 and eng.solves == 2 and eng.solved == 6
    for s, r in zip(signals, results):
        solo = jfista(JLasso(filt=jfilt, y=np.asarray(s), mu=2.0), n_iters=15, backend="dense")
        _close(r.x, solo.x, rtol=1e-4, atol=1e-4)
        assert tuple(r.aux.shape) == (filt.eta, 96) and r.x.device.type == "cpu"
        assert isinstance(r.history, np.ndarray) and r.history.shape == (15,)


def test_flush_solves_empty_lane_drains_without_solver(sgwt_setting):
    """tests/test_solvers.py:293-303."""
    _, filt = sgwt_setting
    eng = tserve.GraphFilterEngine(filt, backend="dense", panel_width=2, device="cpu")
    assert eng.flush_solves() is None
    with pytest.raises(ValueError, match="no solver"):
        eng.submit_solve(np.zeros(4, np.float32))


# ------------------------------------------------------- async engine ----


def _async_engine(pkg, filt, **cfg):
    defaults = dict(max_panel=8, min_bucket=4, latency_budget_s=0.05)
    defaults.update(cfg)
    kw = {"device": "cpu"} if pkg is tserve else {}
    return pkg.AsyncGraphFilterEngine(
        filt, backend="dense",
        solver=pkg.lasso_panel_solver(filt, n_iters=4),
        config=pkg.SchedulerConfig(**defaults),
        stream_opts={"max_delta_frac": 1.0}, **kw)


def test_async_ticket_lifecycle_and_deadline(setting):
    jfilt, filt, sigs = setting
    eng = _async_engine(tserve, filt)
    tk = eng.submit(sigs[0], now=0.0)
    assert not tk.done and tk.latency_s is None
    assert eng.poll(tk, now=0.01) is None  # inside the budget: pending
    assert eng.poll(tk, now=0.049) is None
    out = eng.poll(tk, now=0.05)  # deadline fires
    assert tk.done and out is not None
    _close(out, _ref_solo(jfilt, sigs[0]))
    assert tk.latency_s == pytest.approx(0.05 + eng.busy_s)


def test_async_virtual_clock_and_programs_are_public(setting):
    """``busy_until`` is the reference's virtual frontier, ``reset_clock``
    starts a fresh timeline (as a load generator's replay does), and
    ``cache.programs()`` is a read-only view of the built programs."""
    jfilt, filt, sigs = setting
    eng, jeng = _async_engine(tserve, filt), _async_engine(jserve, jfilt)
    assert eng.busy_until == 0.0
    for e in (eng, jeng):
        e.submit(sigs[0], now=1.0)
        e.drain(now=1.0)
    assert eng.busy_until == pytest.approx(1.0 + eng.busy_s)
    assert jeng._busy_until == pytest.approx(1.0 + jeng.busy_s)
    eng.reset_clock()
    assert eng.busy_until == 0.0 and eng.applies == 1 and eng.recompiles == 1
    views = eng.cache.programs()
    assert list(views) == list(jeng.cache._programs) == [("apply", "dense", 96, 4)]
    with pytest.raises(TypeError):
        views[("apply", "dense", 96, 8)] = None
    tk = eng.submit(sigs[1], now=0.5)
    eng.drain(now=0.5)
    # on the fresh timeline the panel starts at its own arrival
    assert tk.latency_s == pytest.approx(eng.busy_until - 0.5)
    assert 0.5 < eng.busy_until < 1.0 and eng.recompiles == 1


def test_async_full_panel_fires_without_deadline(setting):
    jfilt, filt, sigs = setting
    eng = _async_engine(tserve, filt, max_panel=4)
    tks = [eng.submit(s, now=0.0) for s in sigs[:4]]
    eng.step(now=0.0)  # full panel: no deadline wait needed
    assert all(t.done for t in tks)
    for t, s in zip(tks, sigs[:4]):
        _close(t.result, _ref_solo(jfilt, s))


def test_async_wait_forces_partial_panel(setting):
    jfilt, filt, sigs = setting
    eng = _async_engine(tserve, filt)
    tk = eng.submit(sigs[0], now=0.0)
    out = eng.wait(tk, now=0.0)  # force-flush, deadline not reached
    _close(out, _ref_solo(jfilt, sigs[0]))


def test_async_submission_order_within_lane(setting):
    jfilt, filt, sigs = setting
    eng = _async_engine(tserve, filt, max_panel=4)
    tks = [eng.submit(s, now=0.0) for s in sigs[:6]]  # 4 full + 2 partial
    eng.step(now=0.0)
    eng.drain(now=0.0)
    assert [t.done for t in tks] == [True] * 6
    assert [t.tid for t in tks] == sorted(t.tid for t in tks)
    for t, s in zip(tks, sigs[:6]):
        _close(t.result, _ref_solo(jfilt, s))


def test_async_mixed_lane_parity(setting):
    jfilt, filt, sigs = setting
    eng = _async_engine(tserve, filt)
    ta = eng.submit(sigs[0], now=0.0)
    ts = eng.submit_solve(sigs[1], now=0.0)
    tf0 = eng.submit_frame("s", sigs[2], now=0.0)
    tf1 = eng.submit_frame("s", sigs[3], now=0.0)
    eng.drain(now=0.0)
    _close(ta.result, _ref_solo(jfilt, sigs[0]))
    want = _ref_fista(jfilt, sigs[1])
    _close(ts.result.x, want.x)
    _close(ts.result.aux, want.aux)
    np.testing.assert_allclose(ts.result.history, want.history, rtol=1e-4, atol=1e-4)
    assert ts.result.iterations == 4 and ts.result.method == "fista"
    ref = JStream(jfilt, backend="dense", max_delta_frac=1.0)
    _close(tf0.result.out, ref.push(np.asarray(sigs[2])).out)
    _close(tf1.result.out, ref.push(np.asarray(sigs[3])).out)


def _steady_state(pkg, filt, sigs):
    eng = _async_engine(pkg, filt, max_panel=8)
    counts = []
    for t0 in (0.0, 1.0):
        tks = [eng.submit(s, now=t0) for s in sigs[:11]]  # buckets 8 + 4
        tks.append(eng.submit_solve(sigs[11], now=t0))
        eng.step(now=t0)
        eng.drain(now=t0)
        assert all(t.done for t in tks)
        counts.append((eng.recompiles, eng.cache.hits, eng.pad_slots, eng.panel_slots))
    return eng, counts, tks


def test_async_cache_steady_state_zero_recompiles(setting):
    """THE acceptance assertion: replaying an identical workload adds
    zero cache misses, and the counts are the reference's."""
    jfilt, filt, sigs = setting
    eng, counts, tks = _steady_state(tserve, filt, sigs)
    (warm, hits0, *_), (again, hits1, *_) = counts
    assert warm >= 3 and again == warm and hits1 > hits0
    jeng, jcounts, jtks = _steady_state(jserve, jfilt, sigs)
    assert counts == jcounts
    assert sorted(eng.cache.programs()) == sorted(jeng.cache._programs)
    for t, jt in zip(tks, jtks):
        if t.lane == "apply":
            _close(t.result, jt.result)
        else:
            _close(t.result.x, jt.result.x)


def test_async_pad_waste_accounting(setting):
    jfilt, filt, sigs = setting
    for pkg, f in ((tserve, filt), (jserve, jfilt)):
        eng = _async_engine(pkg, f, max_panel=8, min_bucket=4)
        for s in sigs[:3]:  # 3 requests pad to bucket 4
            eng.submit(s, now=0.0)
        eng.drain(now=0.0)
        assert eng.panel_slots == 4 and eng.pad_slots == 1
        assert eng.pad_waste == pytest.approx(0.25)


def test_async_admission_control(setting):
    jfilt, filt, sigs = setting
    for pkg, f in ((tserve, filt), (jserve, jfilt)):
        eng = _async_engine(pkg, f, max_pending_per_tenant=2)
        eng.submit(sigs[0], tenant="a", now=0.0)
        eng.submit(sigs[1], tenant="a", now=0.0)
        with pytest.raises(pkg.AdmissionError):
            eng.submit(sigs[2], tenant="a", now=0.0)
        assert eng.scheduler.rejected == 1
        eng.submit(sigs[3], tenant="b", now=0.0)  # other tenants unaffected
        eng.drain(now=0.0)  # resolving releases the quota
        eng.submit(sigs[4], tenant="a", now=0.0)
        assert eng.scheduler.admitted == 4


def test_async_solve_without_solver_raises(setting):
    _, filt, sigs = setting
    eng = tserve.AsyncGraphFilterEngine(filt, backend="dense", device="cpu")
    with pytest.raises(ValueError, match="no solver"):
        eng.submit_solve(sigs[0], now=0.0)


# ------------------------------------------- stream eviction / churn ----


def _frame_engine(pkg, filt, **kw):
    if pkg is tserve:
        kw["device"] = "cpu"
    return pkg.AsyncGraphFilterEngine(
        filt, backend="dense",
        config=pkg.SchedulerConfig(max_panel=8, min_bucket=4, latency_budget_s=0.05),
        stream_opts={"max_delta_frac": 1.0}, **kw)


def _lru_run(pkg, filt, sigs):
    eng = _frame_engine(pkg, filt, max_streams=3)
    sets = []
    for i in range(5):
        eng.wait(eng.submit_frame(f"s{i}", sigs[i], now=float(i)), now=float(i))
    sets.append((list(eng._streams), eng.streams_evicted))
    eng.wait(eng.submit_frame("s2", sigs[5], now=5.0), now=5.0)
    eng.wait(eng.submit_frame("s9", sigs[6], now=6.0), now=6.0)
    sets.append((list(eng._streams), eng.streams_evicted))
    res = eng.wait(eng.submit_frame("s3", sigs[7], now=7.0), now=7.0)
    sets.append((list(eng._streams), eng.streams_evicted))
    return sets, res


def test_async_stream_eviction_lru_cap(setting):
    """Past max_streams the coldest lanes go in LRU order, the same
    streams as the reference's, and an evicted stream recovers cold."""
    jfilt, filt, sigs = setting
    sets, res = _lru_run(tserve, filt, sigs)
    assert set(sets[0][0]) == {"s2", "s3", "s4"} and sets[0][1] == 2
    assert set(sets[1][0]) == {"s4", "s2", "s9"} and sets[1][1] == 3
    assert res.mode == "full"
    _close(res.out, _ref_solo(jfilt, sigs[7]))
    jsets, jres = _lru_run(jserve, jfilt, sigs)
    assert sets == jsets and res.mode == jres.mode


def _ttl_run(pkg, filt, sigs):
    eng = _frame_engine(pkg, filt, max_streams=None, stream_ttl_s=10.0)
    eng.wait(eng.submit_frame("a", sigs[0], now=0.0), now=0.0)
    eng.wait(eng.submit_frame("b", sigs[1], now=8.0), now=8.0)
    inside = set(eng._streams)
    eng.wait(eng.submit_frame("b", sigs[2], now=15.0), now=15.0)
    st = eng.stats()
    return inside, set(eng._streams), eng.streams_evicted, st["streams"], st["streams_evicted"]


def test_async_stream_eviction_ttl_virtual_clock(setting):
    jfilt, filt, sigs = setting
    got = _ttl_run(tserve, filt, sigs)
    assert got == ({"a", "b"}, {"b"}, 1, 1, 1)
    assert got == _ttl_run(jserve, jfilt, sigs)


def test_async_stream_no_eviction_by_default_within_cap(setting):
    _, filt, sigs = setting
    eng = _frame_engine(tserve, filt)  # defaults: cap 4096, no TTL
    for i in range(8):
        eng.wait(eng.submit_frame(f"s{i}", sigs[i], now=float(i)), now=float(i))
    assert eng.streams_evicted == 0 and len(eng._streams) == 8


def test_async_frame_lane_survives_churn(setting):
    """submit_frame(delta=) mutates only the per-stream lane, and the
    churned stream matches the reference lane fed the same deltas."""
    jfilt, filt, sigs = setting
    eng = _frame_engine(tserve, filt, stream_ttl_s=None)
    adj0 = filt.graph.adjacency.clone()
    uu, vv = np.nonzero(np.triu(adj0.numpy(), 1))
    edits = ((int(uu[0]), int(vv[0]), 0.0), (int(uu[1]), int(vv[1]), 2.0))
    ref = JStream(jfilt, backend="dense", max_delta_frac=1.0)
    eng.wait(eng.submit_frame("churny", sigs[0], now=0.0), now=0.0)
    ref.push(np.asarray(sigs[0]))
    res = eng.wait(eng.submit_frame("churny", sigs[1], delta=GraphDelta(edits), now=1.0), now=1.0)
    want = ref.push(np.asarray(sigs[1]), delta=JGraphDelta(edits))
    _close(res.out, want.out)
    assert res.edges_changed == 2 == want.edges_changed and res.mode == want.mode
    assert eng._streams["churny"].graph_version == 1
    assert torch.equal(filt.graph.adjacency, adj0)
    res2 = eng.wait(eng.submit_frame("other", sigs[2], now=2.0), now=2.0)
    _close(res2.out, _ref_solo(jfilt, sigs[2]))
    assert eng._streams["other"].graph_version == 0


# -------------------------------------------- solver-backend binding ----


def test_solver_binding_inherits_engine_backend(setting):
    _, filt, _ = setting
    spec = tserve.lasso_panel_solver(filt, n_iters=4)  # backend=None: inherit
    eng = tserve.GraphFilterEngine(filt, backend="dense", solver=spec, device="cpu")
    assert eng.solver.backend == "dense"
    assert eng.solver is not spec and spec.backend is None  # bound a COPY


def test_solver_binding_keeps_explicit_backend(setting):
    _, filt, _ = setting
    spec = tserve.lasso_panel_solver(filt, n_iters=4, backend="bsr")
    eng = tserve.GraphFilterEngine(filt, backend="dense", solver=spec, device="cpu")
    assert eng.solver.backend == "bsr"
    assert eng.solver is spec  # untouched


@pytest.mark.parametrize("bind", [_bind_solver_backend, j_bind], ids=["port", "reference"])
def test_solver_binding_plain_callable_passes_through(bind):
    def custom(panel):  # no backend contract at all
        raise NotImplementedError

    assert bind(custom, "dense") is custom
    assert bind(None, "dense") is None


@pytest.mark.parametrize("bind", [_bind_solver_backend, j_bind], ids=["port", "reference"])
def test_solver_binding_non_dataclass_none_backend_raises(bind):
    class BadSolver:
        backend = None

        def __call__(self, panel):
            raise NotImplementedError

    with pytest.raises(TypeError, match="backend=None"):
        bind(BadSolver(), "dense")


# ------------------------------------------------------ engine lane ----


@pytest.fixture(scope="module")
def grid_setting():
    """tests/test_stream.py:29-38: a 32 x 32 grid and an order-8 union."""
    g = tgraph.grid_graph(GRID_SIDE, device="cpu")
    jg = jgraph.grid_graph(GRID_SIDE)
    bank = [tmult.tikhonov(1.0, 1), tmult.heat(0.5)]
    filt = GraphFilter.from_multipliers(bank, order=ORDER, graph=g, lmax=8.0)
    jfilt = JFilter.from_multipliers(
        [jmult.tikhonov(1.0, 1), jmult.heat(0.5)], order=ORDER, graph=jg, lmax=8.0)
    f0 = np.asarray(jg.coords[:, 0] ** 2 + jg.coords[:, 1] ** 2, np.float32)
    return filt, jfilt, f0


def _patch_frame(f0, r0, c0, patch=3, bump=0.5):
    y = f0.copy()
    rr, cc = np.meshgrid(np.arange(r0, r0 + patch), np.arange(c0, c0 + patch), indexing="ij")
    y[(rr * GRID_SIDE + cc).ravel()] += bump
    return y


def test_engine_streaming_lane_ordering(grid_setting):
    """tests/test_stream.py:343-377: interleaved submit/flush across two
    streams keeps per-stream order; outputs match full applies."""
    filt, jfilt, f0 = grid_setting
    eng = tserve.GraphFilterEngine(filt, backend="dense", panel_width=3, device="cpu")
    frames_a = [f0] + [_patch_frame(f0, 4 + t, 4) for t in range(2)]
    frames_b = [2.0 * f0, _patch_frame(2.0 * f0, 8, 8)]

    got = []
    assert eng.submit_frame("a", frames_a[0]) is None
    assert eng.submit_frame("b", frames_b[0]) is None
    out = eng.submit_frame("a", frames_a[1])  # panel_width reached
    assert out is not None and len(out) == 3
    got.extend([("a", out[0]), ("b", out[1]), ("a", out[2])])
    assert eng.flush_frames() is None
    assert eng.submit_frame("b", frames_b[1]) is None
    assert eng.submit_frame("a", frames_a[2]) is None
    out = eng.flush_frames()
    assert out is not None and len(out) == 2
    got.extend([("b", out[0]), ("a", out[1])])

    per_stream = {"a": [], "b": []}
    for sid, res in got:
        per_stream[sid].append(res)
    assert [r.frame for r in per_stream["a"]] == [0, 1, 2]
    assert [r.frame for r in per_stream["b"]] == [0, 1]
    assert [r.mode for r in per_stream["a"]] == ["full", "delta", "delta"]
    for frames, results in ((frames_a, per_stream["a"]), (frames_b, per_stream["b"])):
        for y, res in zip(frames, results):
            _close(res.out, np.asarray(jfilt.apply(np.asarray(y), backend="dense")))
    assert eng.frames_served == 5
    assert eng.stream_latency_s > 0.0


def test_engine_streaming_lane_isolated_from_other_lanes(grid_setting):
    """tests/test_stream.py:380-390."""
    filt, _, f0 = grid_setting
    eng = tserve.GraphFilterEngine(filt, backend="dense", panel_width=2, device="cpu")
    assert eng.submit_frame("s", f0) is None
    reqs = [eng.submit(f0), eng.submit(2.0 * f0)]
    assert reqs[0] is None and reqs[1] is not None
    out = eng.flush_frames()
    assert len(out) == 1 and out[0].mode == "full"
    assert eng.served == 2 and eng.frames_served == 1


# ------------------------------------------------ port-only contract ----


def test_engines_refuse_a_filter_on_another_device(setting):
    _, filt, _ = setting
    for make in (tserve.GraphFilterEngine, tserve.AsyncGraphFilterEngine):
        with pytest.raises(ValueError, match="is on cpu, not on meta"):
            make(filt, device="meta")


def test_answers_are_host_storage_of_their_own(setting):
    """One host copy per panel into a buffer of the panel's own: a later
    panel never overwrites an earlier answer."""
    jfilt, filt, sigs = setting
    eng = _async_engine(tserve, filt, max_panel=4)
    first = eng.wait(eng.submit(sigs[0], now=0.0), now=0.0)
    kept = first.clone()
    eng.wait(eng.submit(sigs[1], now=0.0), now=0.0)
    assert torch.equal(first, kept)
    sol = eng.wait(eng.submit_solve(sigs[2], now=0.0), now=0.0)
    assert sol.x.device.type == "cpu" and sol.aux.device.type == "cpu"
    assert isinstance(sol.history, np.ndarray) and sol.history.dtype == np.float64
    assert eng.stats()["captures"] == 0  # programs are recorded only on the card
