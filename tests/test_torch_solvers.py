"""Port parity for ``repro_torch.solvers`` and the solver-backed apps.

The same numpy inputs go through the JAX package (``repro``, on the CPU)
and the port (``repro_torch``, on the CPU: the ``bsr`` backend runs the
kernels' plain versions). Graphs are the reference's own, drawn by
``jax.random`` and carried across with ``repro_torch.interop``:

* the 96-node ``small_setting`` of ``tests/test_solvers.py``;
* the Sec. V-C 500-node graph of ``benchmarks/run.py::tab_solvers``, on
  which the port's CG, PCG and ``cheb_inverse`` iteration counts are held
  to the reference's run on the same system (within one), and then to
  ``BENCH_pr10.json``'s platform-free numbers (CG 18, PCG 7 at fit order
  32, ``cheb_inverse`` 41 at order 16 with 54 predicted,
  ``fista_at_half_wins = 1``) within one iteration.

Tolerances are the reference tests': lasso ``x``/``a`` 1e-5 and history
1e-4 (``tests/test_solvers.py:128-138``); Gram solvers rtol 1e-3, atol
1e-4 (``tests/test_multishift.py:333-346``); iteration counts equal or
within one (``tests/test_solvers.py:166``). Host-side numpy functions
match to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apps as japps
from repro import solvers as js
from repro.core import chebyshev as jcheb
from repro.core import graph as jgraph
from repro.core import multipliers as jmult
from repro.filters import GraphFilter as JFilter
from repro.filters import backend_capabilities as jcaps
from repro.filters import registry as jregistry
from repro.solvers import loops as jloops
from repro_torch import apps as tapps
from repro_torch import interop
from repro_torch import solvers as ts
from repro_torch.core import chebyshev as tcheb
from repro_torch.core import multipliers as tmult
from repro_torch.filters import GraphFilter
from repro_torch.filters import backends as tbackends
from repro_torch.filters import registry as tregistry
from repro_torch.solvers import loops as tloops

LASSO_TOL, HIST_TOL = 1e-5, 1e-4
GRAM_RTOL, GRAM_ATOL = 1e-3, 1e-4
BACKENDS = [("dense", {}), ("bsr", {"fuse": True}), ("bsr", {"fuse": False})]
BACKEND_IDS = ["dense", "bsr-fused", "bsr-stepwise"]


@pytest.fixture(scope="module")
def small():
    """The reference's 96-node SGWT lasso setting and its port twin."""
    g = jgraph.connected_sensor_graph(jax.random.PRNGKey(1), n=96, sigma=0.17, kappa=0.18)
    lmax = float(g.lmax_bound())
    f0 = g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2 - 1.0
    y = f0 + 0.5 * jax.random.normal(jax.random.PRNGKey(2), f0.shape)
    jf = JFilter.from_multipliers(jmult.sgwt_filter_bank(lmax, n_scales=3), 16, graph=g, lmax=lmax)
    tg = interop.sensor_graph_from_numpy(np.array(g.adjacency), np.array(g.coords), "cpu")
    return {"g": g, "lmax": lmax, "f0": np.array(f0), "y": np.array(y), "jf": jf, "tg": tg}


@pytest.fixture(scope="module")
def sec_vc():
    """The Sec. V-C benchmark graph (500 nodes, 3 scales, order 20) as
    ``benchmarks/run.py::tab_solvers`` draws it, on the port's dense."""
    kg, kn = jax.random.split(jax.random.PRNGKey(42))
    g = jgraph.connected_sensor_graph(kg, n=500)
    lmax = float(g.lmax_bound())
    f0 = g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2 - 1.0
    y = f0 + 0.5 * jax.random.normal(kn, f0.shape)
    jf = JFilter.from_multipliers(jmult.sgwt_filter_bank(lmax, n_scales=3), 20, graph=g, lmax=lmax)
    tg = interop.sensor_graph_from_numpy(np.array(g.adjacency), np.array(g.coords), "cpu")
    tf = interop.filter_from_numpy(jf.coeffs, lmax, tg)
    obs = tf.apply(torch.as_tensor(np.array(f0)))
    gram = ts.GramProblem(filt=tf, b=tf.adjoint(obs), reg=1e-6)
    jgram = js.GramProblem(filt=jf, b=jnp.asarray(gram.b.numpy()), reg=1e-6)
    return {"f0": np.array(f0), "y": np.array(y), "filt": tf, "gram": gram, "jgram": jgram}


@pytest.fixture(scope="module")
def sec_vc_ref(sec_vc):
    """The reference's CG, PCG (fit order 32) and ``cheb_inverse`` (order
    16) on the same Sec. V-C system, on its ``dense`` backend."""
    jgram = sec_vc["jgram"]
    kw = dict(n_iters=150, tol=1e-6)
    return {
        "cg": js.conjugate_gradient(jgram, **kw),
        "pcg": js.conjugate_gradient(jgram, preconditioner=js.cheb_preconditioner(jgram, order=32),
                                     **kw),
        "inverse": js.cheb_inverse(jgram, order=16, **kw),
    }


def _lasso(s, **kw):
    return interop.problem_from_numpy(s["jf"].coeffs, s["jf"].lmax, s["tg"], y=s["y"], **kw)


def _gram(s, b=None, reg=1.0):
    return interop.problem_from_numpy(
        s["jf"].coeffs, s["jf"].lmax, s["tg"], b=s["y"] if b is None else b, reg=reg
    )


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------- host functions ----


@pytest.mark.parametrize("order,reg,quad_points",
                         [(8, 1e-6, None), (16, 1e-2, None), (5, 0.5, 100)])
def test_inverse_fit_functions_match_reference_bitwise(small, order, reg, quad_points):
    jf = small["jf"]
    want = jcheb.inverse_coefficients(jf.gram_coeffs, jf.lmax, order, reg=reg,
                                      quad_points=quad_points)
    got = tcheb.inverse_coefficients(jf.gram_coeffs, jf.lmax, order, reg=reg,
                                     quad_points=quad_points)
    assert got.shape == (order + 1,) and np.array_equal(got, want)
    assert tcheb.inverse_fixed_point_rate(got, jf.gram_coeffs, jf.lmax, reg=reg) == \
        jcheb.inverse_fixed_point_rate(want, jf.gram_coeffs, jf.lmax, reg=reg)


def test_inverse_fit_refuses_a_nonpositive_denominator_like_reference(small):
    jf = small["jf"]
    with pytest.raises(ValueError) as want:
        jcheb.inverse_coefficients(jf.gram_coeffs, jf.lmax, 8, reg=-10.0)
    with pytest.raises(ValueError) as got:
        tcheb.inverse_coefficients(jf.gram_coeffs, jf.lmax, 8, reg=-10.0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_shifts", [1, 2])
def test_cheb_eval_joint_matches_reference_bitwise(n_shifts):
    rng = np.random.RandomState(n_shifts)
    coeffs = rng.randn(*((3,) + (7,) * n_shifts))
    lmaxes = [4.0, 2.5][:n_shifts]
    xs = [np.linspace(0.0, lm, 33 + r) for r, lm in enumerate(lmaxes)]
    got = tcheb.cheb_eval_joint(coeffs, xs, lmaxes)
    assert np.array_equal(got, jcheb.cheb_eval_joint(coeffs, xs, lmaxes))
    if n_shifts == 1:  # one shift: the joint evaluator is cheb_eval
        np.testing.assert_allclose(got, tcheb.cheb_eval(coeffs, xs[0], lmaxes[0]), atol=1e-12)


# ------------------------------------------------------------ iterate ---


def _halving_steps():
    """The same step in both packages: x <- x / 2, trace x + 1/3 (not exact
    in float32), stop x."""

    def jstep(x):
        x = x * 0.5
        return x, (x + 1.0 / 3.0, x)

    def tstep(x):
        x = x * 0.5
        return x, (x + 1.0 / 3.0, x)

    return jstep, jnp.asarray(1.0, jnp.float32), tstep, torch.tensor(1.0)


@pytest.mark.parametrize(
    "tol,traceable", [(None, True), (1e-3, True), (None, False), (1e-3, False)],
    ids=["scan", "while", "host-fixed", "host-tol"],
)
def test_iterate_matches_reference(tol, traceable):
    jstep, jinit, tstep, tinit = _halving_steps()
    js_, jh, jk, jc = jloops.iterate(jstep, jinit, n_iters=25, tol=tol, traceable=traceable)
    ts_, th, tk, tc = tloops.iterate(tstep, tinit, n_iters=25, tol=tol, traceable=traceable)
    assert (tk, tc) == (jk, jc)
    assert th.dtype == np.float64 and np.array_equal(th, jh)
    assert float(ts_) == float(js_)
    if traceable:  # history is float32 rounded
        assert np.array_equal(th, th.astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("traceable", [True, False], ids=["traceable", "host"])
def test_iterate_tol_test_rounds_like_reference(traceable):
    # stop = float32(1e-7) sits above 1e-7 in float64 but equals
    # float32(1e-7): the compiled loops stop at once, the host loop never.
    def jstep(x):
        return x, (x, jnp.asarray(1e-7, jnp.float32))

    def tstep(x):
        return x, (x, torch.tensor(1e-7, dtype=torch.float32))

    kw = dict(n_iters=5, tol=1e-7, traceable=traceable)
    _, jh, jk, jc = jloops.iterate(jstep, jnp.float32(2.0), **kw)
    _, th, tk, tc = tloops.iterate(tstep, torch.tensor(2.0), **kw)
    assert (tk, tc) == (jk, jc) == ((1, True) if traceable else (5, False))
    assert np.array_equal(th, jh)


@pytest.mark.parametrize("tol", [None, 1e-3], ids=["fixed", "tol"])
def test_iterate_edge_budgets(tol):
    _, _, tstep, tinit = _halving_steps()
    state, hist, k, conv = tloops.iterate(tstep, tinit, n_iters=0, tol=tol, traceable=True)
    assert state is tinit and hist.shape == (0,) and hist.dtype == np.float64
    assert (k, conv) == (0, tol is None)
    with pytest.raises(ValueError) as got:
        tloops.iterate(tstep, tinit, n_iters=-1, tol=tol, traceable=True)
    with pytest.raises(ValueError) as want:
        jloops.iterate(tstep, tinit, n_iters=-1, tol=tol, traceable=True)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------- lasso ---


@pytest.fixture(scope="module")
def ref_lasso(small):
    problem = js.LassoProblem(filt=small["jf"], y=jnp.asarray(small["y"]), mu=2.0)
    return {m: getattr(js, m)(problem, n_iters=10) for m in ("ista", "fista")}


@pytest.mark.parametrize("backend,opts", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("method", ["ista", "fista"])
def test_lasso_matches_reference(small, ref_lasso, method, backend, opts):
    want = ref_lasso[method]
    got = getattr(ts, method)(_lasso(small, mu=2.0), n_iters=10, backend=backend, **opts)
    assert (got.iterations, got.converged, got.method) == (10, True, method)
    assert got.x.dtype == torch.float32 and got.aux.shape == (4, 96)
    _close(got.x, want.x, LASSO_TOL, LASSO_TOL)
    _close(got.aux, want.aux, LASSO_TOL, LASSO_TOL)
    np.testing.assert_allclose(got.history, want.history, rtol=HIST_TOL, atol=HIST_TOL)
    assert got.messages_per_iteration == want.messages_per_iteration == 0


@pytest.mark.parametrize("method,tol", [("ista", 1e-3), ("fista", 1e-2)])
def test_lasso_tol_mode_matches_reference(small, method, tol):
    # FISTA's objective is not monotone: its relative change stays above
    # 3e-3 for 60 iterations here, in the reference as in the port.
    problem = js.LassoProblem(filt=small["jf"], y=jnp.asarray(small["y"]), mu=2.0)
    want = getattr(js, method)(problem, n_iters=60, tol=tol)
    got = getattr(ts, method)(_lasso(small, mu=2.0), n_iters=60, tol=tol, backend="bsr")
    assert want.converged and got.converged
    assert abs(got.iterations - want.iterations) <= 1
    if got.iterations == want.iterations:
        _close(got.x, want.x, LASSO_TOL, LASSO_TOL)
        np.testing.assert_allclose(got.history, want.history, rtol=HIST_TOL, atol=HIST_TOL)


@pytest.mark.parametrize("method", ["ista", "fista"])
def test_lasso_warm_start_matches_reference(small, ref_lasso, method):
    problem = js.LassoProblem(filt=small["jf"], y=jnp.asarray(small["y"]), mu=2.0)
    a0 = np.array(ref_lasso[method].aux)
    want = getattr(js, method)(problem, a0=jnp.asarray(a0), n_iters=5)
    got = getattr(ts, method)(_lasso(small, mu=2.0), a0=a0, n_iters=5, backend="bsr")
    _close(got.x, want.x, LASSO_TOL, LASSO_TOL)
    np.testing.assert_allclose(got.history, want.history, rtol=HIST_TOL, atol=HIST_TOL)


def test_reference_bsr_lasso_matches_port_bsr(small, ref_lasso):
    """The one run of the reference's Pallas-interpret bsr: 10 ISTA
    iterations against the port's bsr (plain kernel versions)."""
    problem = js.LassoProblem(filt=small["jf"], y=jnp.asarray(small["y"]), mu=2.0)
    want = js.ista(problem, n_iters=10, backend="bsr")
    got = ts.ista(_lasso(small, mu=2.0), n_iters=10, backend="bsr")
    _close(got.x, want.x, LASSO_TOL, LASSO_TOL)
    _close(got.aux, want.aux, LASSO_TOL, LASSO_TOL)
    np.testing.assert_allclose(got.history, want.history, rtol=HIST_TOL, atol=HIST_TOL)


class _HostLoopDense(tbackends.DenseBackend):
    """The dense backend declared non-traceable: drives the host loop."""

    name = "hostloop"
    capabilities = tregistry.BackendCapabilities(traceable=False)


def test_host_loop_backend_matches_reference_scan(small, ref_lasso, monkeypatch):
    monkeypatch.setitem(tregistry._REGISTRY, "hostloop", _HostLoopDense())
    got = ts.ista(_lasso(small, mu=2.0), n_iters=10, backend="hostloop")
    want = ref_lasso["ista"]
    _close(got.x, want.x, LASSO_TOL, LASSO_TOL)
    np.testing.assert_allclose(got.history, want.history, rtol=HIST_TOL, atol=HIST_TOL)
    cg_host = ts.conjugate_gradient(_gram(small), n_iters=100, tol=1e-5, backend="hostloop")
    cg_ref = js.conjugate_gradient(js.GramProblem(filt=small["jf"], b=jnp.asarray(small["y"]),
                                                  reg=1.0), n_iters=100, tol=1e-5)
    assert cg_host.converged and abs(cg_host.iterations - cg_ref.iterations) <= 1


@pytest.mark.parametrize("method", ["ista", "fista"])
def test_lasso_panel_program_matches_reference(small, method):
    panel = np.random.RandomState(3).randn(96, 3).astype(np.float32)
    want_x, want_a, want_h = js.lasso_panel_program(
        small["jf"], method=method, mu=2.0, n_iters=8)(jnp.asarray(panel))
    tf = interop.filter_from_numpy(small["jf"].coeffs, small["jf"].lmax, small["tg"])
    got_x, got_a, got_h = ts.lasso_panel_program(
        tf, method=method, mu=2.0, n_iters=8, backend="bsr")(torch.as_tensor(panel))
    assert got_h.dtype == torch.float32 and got_h.shape == (8,) and got_a.shape == (4, 96, 3)
    _close(got_x, want_x, LASSO_TOL, LASSO_TOL)
    _close(got_a, want_a, LASSO_TOL, LASSO_TOL)
    _close(got_h, want_h, HIST_TOL, HIST_TOL)


# -------------------------------------------------------- Gram solvers ---


def _ref_gram(small, reg):
    return js.GramProblem(filt=small["jf"], b=jnp.asarray(small["y"]), reg=reg)


def _run_gram_solver(pkg, solver, problem, backend, opts):
    kw = dict(n_iters=200, tol=1e-6, **opts)
    if pkg is ts:
        kw["backend"] = backend
    if solver == "cg":
        return pkg.conjugate_gradient(problem, **kw)
    if solver == "pcg":
        pre = pkg.cheb_preconditioner(problem, order=8, **{k: v for k, v in kw.items()
                                                           if k not in ("n_iters", "tol")})
        return pkg.conjugate_gradient(problem, preconditioner=pre, **kw)
    if solver == "cheb_inverse":
        return pkg.cheb_inverse(problem, order=16, **kw)
    return pkg.wiener(problem.filt, problem.b, problem.reg, **kw)


@pytest.mark.parametrize("backend,opts", BACKENDS[:2], ids=BACKEND_IDS[:2])
@pytest.mark.parametrize("solver", ["cg", "pcg", "cheb_inverse", "wiener"])
def test_gram_solvers_match_reference(small, solver, backend, opts):
    reg = 1e-2
    want = _run_gram_solver(js, solver, _ref_gram(small, reg), "dense", {})
    got = _run_gram_solver(ts, solver, _gram(small, reg=reg), backend, opts)
    assert got.method == want.method and got.converged == want.converged
    assert abs(got.iterations - want.iterations) <= 1, (got.iterations, want.iterations)
    assert got.x.dtype == torch.float32  # float64 fits do not promote the solve
    _close(got.x, want.x, GRAM_RTOL, GRAM_ATOL)
    assert got.messages_per_iteration == want.messages_per_iteration == 0
    if solver == "cheb_inverse":  # the host-side fit is the reference's, to the bit
        assert got.aux.orders == want.aux.orders and got.aux.rate == want.aux.rate
        assert np.array_equal(got.aux.coeffs, want.aux.coeffs)


def test_cg_panel_matches_reference(small):
    panel = np.random.RandomState(0).randn(96, 3).astype(np.float32)
    want = js.conjugate_gradient(
        js.GramProblem(filt=small["jf"], b=jnp.asarray(panel), reg=0.5), n_iters=150, tol=1e-6)
    got = ts.conjugate_gradient(_gram(small, b=panel, reg=0.5), n_iters=150, tol=1e-6,
                                backend="bsr")
    assert got.converged and abs(got.iterations - want.iterations) <= 1
    _close(got.x, want.x, GRAM_RTOL, GRAM_ATOL)


@pytest.mark.parametrize("backend", ["dense", "bsr"])
@pytest.mark.parametrize("app", ["wavelet_ista", "wavelet_fista", "wiener", "inverse"])
def test_apps_match_reference(small, app, backend):
    g, lmax, f0, y = small["g"], small["lmax"], small["f0"], small["y"]
    tg = small["tg"]
    if app.startswith("wavelet"):
        kw = dict(n_scales=3, order=16, mu=2.0, n_iters=20, method=app.split("_")[1],
                  full_output=True)
        want = japps.wavelet_denoise_ista(g, jnp.asarray(y), lmax, **kw)
        got = tapps.wavelet_denoise_ista(tg, y, lmax, backend=backend, **kw)
        tols = (LASSO_TOL, LASSO_TOL)
    elif app == "wiener":  # tests/test_solvers.py::test_wiener_denoises
        kw = dict(noise_power=0.25, order=16, n_iters=100, tol=1e-8, full_output=True)
        want = japps.denoise_wiener(g, jnp.asarray(y), lmax, **kw)
        got = tapps.denoise_wiener(tg, y, lmax, backend=backend, **kw)
        tols = (GRAM_RTOL, GRAM_ATOL)
        assert np.mean((got.x.numpy() - f0) ** 2) < 0.5 * np.mean((y - f0) ** 2)
    else:
        jbank, tbank, obs = _inverse_setting(small)
        kw = dict(order=16, reg=0.5, n_iters=300, tol=1e-6, full_output=True)
        want = japps.inverse_filter(g, jnp.asarray(obs), lmax, bank=jbank, **kw)
        got = tapps.inverse_filter(tg, obs, lmax, bank=tbank, backend=backend, **kw)
        tols = (GRAM_RTOL, GRAM_ATOL)
    assert got.method == want.method and got.converged == want.converged
    assert abs(got.iterations - want.iterations) <= 1
    _close(got.x, want.x, *tols)


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_inverse_filter_recovers_signal_like_reference(small, backend):
    """``tests/test_solvers.py::test_inverse_filter_recovers_signal`` on the
    port, held to the reference's solution too. At reg = 1e-8 the Gram
    system is ill-conditioned and float32 rounding sets how many CG
    iterations reach tol: the reference's own backends disagree by more
    than one there (reg = 1e-3, tol = 1e-6: dense 51, bsr 56, allgather
    55), so the counts are compared only at reg = 0.5 above."""
    jbank, tbank, obs = _inverse_setting(small)
    kw = dict(order=16, reg=1e-8, n_iters=300, tol=1e-10)
    want = japps.inverse_filter(small["g"], jnp.asarray(obs), small["lmax"], bank=jbank, **kw)
    got = tapps.inverse_filter(small["tg"], obs, small["lmax"], bank=tbank, backend=backend, **kw)
    assert float(np.max(np.abs(got.numpy() - small["f0"]))) < 1e-2
    _close(got, want, GRAM_RTOL, GRAM_ATOL)


def _inverse_setting(small):
    jbank = [jmult.heat(0.5), jmult.tikhonov(1.0, 1)]
    tbank = [tmult.heat(0.5), tmult.tikhonov(1.0, 1)]
    obs = JFilter.from_multipliers(jbank, 16, graph=small["g"], lmax=small["lmax"]).apply(
        jnp.asarray(small["f0"]))
    return jbank, tbank, np.array(obs)


def test_apps_return_pairs_and_refuse_non_graphs(small):
    x, a = tapps.wavelet_denoise_ista(small["tg"], small["y"], small["lmax"], n_scales=3,
                                      order=16, n_iters=2)
    assert x.shape == (96,) and a.shape == (4, 96)
    assert tapps.denoise_wiener(small["tg"], small["y"], small["lmax"], n_iters=3).shape == (96,)
    with pytest.raises(TypeError, match="SensorGraph"):
        tapps.wavelet_denoise_ista(np.eye(3), small["y"], small["lmax"])


# ------------------------------------------------------- Sec. V-C -------


def test_sec_vc_fista_at_half_wins(sec_vc):
    problem = ts.LassoProblem(filt=sec_vc["filt"], y=sec_vc["y"], mu=2.0)
    obj_i = problem.objective(ts.ista(problem, n_iters=40).aux)
    obj_f = problem.objective(ts.fista(problem, n_iters=20).aux)
    assert obj_f <= obj_i * (1.0 + 1e-4), (obj_i, obj_f)  # fista_at_half_wins = 1


def test_sec_vc_cg_and_pcg_iterations(sec_vc, sec_vc_ref):
    plain = ts.conjugate_gradient(sec_vc["gram"], n_iters=150, tol=1e-6)
    want = sec_vc_ref["cg"]
    assert plain.converged and want.converged
    assert abs(plain.iterations - want.iterations) <= 1, (plain.iterations, want.iterations)
    _close(plain.x, want.x, GRAM_RTOL, GRAM_ATOL)
    assert abs(plain.iterations - 18) <= 1, plain.iterations  # BENCH_pr10.json
    assert float(np.max(np.abs(plain.x.numpy() - sec_vc["f0"]))) < 1e-4
    pre = ts.cheb_preconditioner(sec_vc["gram"], order=32)
    assert pre.orders == (32,) and pre.rate < 1.0
    pcg = ts.conjugate_gradient(sec_vc["gram"], n_iters=150, tol=1e-6, preconditioner=pre)
    want = sec_vc_ref["pcg"]
    assert pcg.converged and want.converged and want.method == "pcg"
    assert abs(pcg.iterations - want.iterations) <= 1, (pcg.iterations, want.iterations)
    _close(pcg.x, want.x, GRAM_RTOL, GRAM_ATOL)
    assert abs(pcg.iterations - 7) <= 1, pcg.iterations  # BENCH_pr10.json
    assert pcg.method == "pcg" and pcg.iterations <= plain.iterations // 2  # pcg_halves


def test_sec_vc_cheb_inverse_iterations(sec_vc, sec_vc_ref):
    res = ts.cheb_inverse(sec_vc["gram"], order=16, n_iters=150, tol=1e-6)
    want = sec_vc_ref["inverse"]
    assert res.converged and want.converged
    assert abs(res.iterations - want.iterations) <= 1, (res.iterations, want.iterations)
    _close(res.x, want.x, GRAM_RTOL, GRAM_ATOL)
    assert abs(res.iterations - 41) <= 1, res.iterations  # BENCH_pr10.json
    predicted = int(np.ceil(np.log(1e-6) / np.log(res.aux.rate)))
    assert res.aux.orders == (16,) and predicted == 54
    assert res.iterations <= predicted + 5


# ---------------------------------------------------------- errors ------


def test_solve_dispatch_and_errors_match_reference(small):
    lasso = _lasso(small, mu=2.0)
    assert ts.solve(lasso, n_iters=2).method == "fista"
    assert ts.solve(lasso, method="ista", n_iters=2).method == "ista"
    gram = _gram(small)
    assert ts.solve(gram, n_iters=2, tol=None).method == "cg"
    jlasso = js.LassoProblem(filt=small["jf"], y=jnp.asarray(small["y"]), mu=2.0)
    jgram = _ref_gram(small, 1.0)
    for (tp, jp, kw) in ((lasso, jlasso, {"method": "cg"}), (gram, jgram, {"method": "fista"}),
                         (object(), object(), {})):
        with pytest.raises((ValueError, TypeError)) as got:
            ts.solve(tp, n_iters=2, **kw)
        with pytest.raises((ValueError, TypeError)) as want:
            js.solve(jp, n_iters=2, **kw)
        assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_lasso_panel_program_errors_match_reference(small):
    tf = interop.filter_from_numpy(small["jf"].coeffs, small["jf"].lmax, small["tg"])
    with pytest.raises(ValueError) as got:
        ts.lasso_panel_program(tf, method="cg")
    with pytest.raises(ValueError) as want:
        js.lasso_panel_program(small["jf"], method="cg")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        ts.lasso_panel_program(tf, backend="allgather")  # non-traceable on both sides
    with pytest.raises(ValueError) as want:
        js.lasso_panel_program(small["jf"], backend="allgather")
    assert str(got.value) == str(want.value)


def test_preconditioner_max_order_error_matches_reference(small):
    with pytest.raises(ValueError, match="no SPD contracting fit") as got:
        ts.cheb_preconditioner(_gram(small, reg=1e-6), order=4, max_order=4)
    with pytest.raises(ValueError) as want:
        js.cheb_preconditioner(_ref_gram(small, 1e-6), order=4, max_order=4)
    assert str(got.value) == str(want.value)


def test_multi_shift_problem_raises_not_implemented():
    """The joint branches are ported: a two-shift problem gets the
    reference's tensor-grid fit, and a backend without ``multi_shift``
    refuses it with the reference's error (nothing raises
    ``NotImplementedError`` any more)."""
    c = np.ones((1, 3, 3)) / 4
    gram = tcheb.joint_gram_coefficients(c)
    filt = GraphFilter(coeffs=c, lmax=2.0, gram_coeffs=gram, lmaxes=(2.0, 3.0))
    jfilt = JFilter(coeffs=c, lmax=2.0, gram_coeffs=gram, lmaxes=(2.0, 3.0))
    assert filt.n_shifts == 2
    problem = ts.GramProblem(filt=filt, b=torch.zeros(4), reg=1.0)
    jproblem = js.GramProblem(filt=jfilt, b=jnp.zeros(4), reg=1.0)
    got, want = ts.cheb_preconditioner(problem), js.cheb_preconditioner(jproblem)
    assert got.orders == want.orders == (8, 8) and got.rate == want.rate < 1.0
    np.testing.assert_array_equal(got.coeffs, want.coeffs)
    with pytest.raises(ValueError, match="'matvec'.*'multi_shift'") as got_exc:
        ts.cheb_inverse(problem, backend="matvec", matvec=lambda v: v)
    with pytest.raises(ValueError) as want_exc:
        js.cheb_inverse(jproblem, backend="matvec", matvec=lambda v: v)
    assert str(got_exc.value) == str(want_exc.value)


def test_mu_vector_matches_reference(small):
    jp = js.LassoProblem(filt=small["jf"], y=jnp.asarray(small["y"]), mu=2.0)
    tp = _lasso(small, mu=2.0)
    np.testing.assert_array_equal(tp.mu_vector().numpy(), np.asarray(jp.mu_vector()))
    assert tp.mu_vector().dtype == torch.float32 and tp.mu_vector().shape == (4, 1)
    assert tp.step_size() == jp.step_size()
    with pytest.raises(ValueError, match="mu must be scalar or shape"):
        _lasso(small, mu=np.ones(3)).mu_vector()
    assert _lasso(small, mu=np.arange(4.0)).mu_vector()[0, 0] == 0.0


# ---------------------------------------------------------- registry ----


@pytest.mark.parametrize("backend", ["dense", "bsr", "matvec", "halo", "allgather", "grid"])
def test_capability_queries_agree_with_reference(backend):
    from repro_torch import filters as tfilters

    assert tfilters.backend_is_traceable(backend) == jregistry.backend_is_traceable(backend)
    assert tfilters.backend_capabilities(backend) == tregistry.get_backend(backend).capabilities
    # sparse input is ported: the same matrix on both sides
    assert (tfilters.backend_supports_sparse(backend)
            == jregistry.backend_supports_sparse(backend)
            == (backend == "dense"))
    # multi-shift joint filters are ported: the same matrix on both sides
    assert (tfilters.backend_supports_multi_shift(backend)
            == jregistry.backend_supports_multi_shift(backend)
            == (backend in ("dense", "bsr", "halo")))
    if backend in ("halo", "allgather", "grid"):
        # the distributed backends drive the host loop on both sides
        assert not jcaps(backend).traceable
    else:
        assert jcaps(backend).traceable


def test_problem_from_numpy_needs_one_of_y_and_b(small):
    with pytest.raises(ValueError, match="exactly one"):
        interop.problem_from_numpy(small["jf"].coeffs, small["jf"].lmax, small["tg"])
    p = interop.problem_from_numpy(small["jf"].coeffs, small["jf"].lmax, small["tg"],
                                   y=small["y"], mu=np.arange(4.0))
    assert p.y.dtype == torch.float32 and p.mu.dtype == torch.float32
    assert p.filt.graph is small["tg"] and p.y.device == small["tg"].device
