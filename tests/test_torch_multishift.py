"""Port parity for multi-shift joint filters (``GraphFilter.from_shifts``):
the joint coefficient functions and recurrences of
``repro_torch.core.chebyshev``, the ``dense``, ``bsr`` and ``halo``
backends' joint paths, the per-shift partition plans and words, the
capability matrix, and the solvers' joint branches, held against the JAX
package on its own time-vertex product setting
(``tests/test_multishift.py``: a 24-sensor graph times a path of 6, a
heat/Tikhonov bank at M = 8 on the sensor shift, heat at M = 5 on the
time shift), carried across with ``interop.joint_filter_from_numpy``.

Tolerances are the reference tests': the kron eigh oracle 1e-5, the
adjoint identity rtol 2e-5, gram against composition 5e-4, panel against
columns 1e-5; coefficients to 1e-12; plans bit for bit; words exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as js
from repro.core import chebyshev as jcheb
from repro.core import distributed as jdist
from repro.core import graph as jgraph
from repro.core import multipliers as jmult
from repro.filters import GraphFilter as JFilter
from repro.filters import registry as jregistry
from repro_torch import interop
from repro_torch import solvers as ts
from repro_torch.core import chebyshev as tcheb
from repro_torch.core import collectives
from repro_torch.core import distributed as tdist
from repro_torch.filters import (
    GraphFilter,
    available_backends,
    backend_capabilities,
    backend_supports_multi_shift,
    require_capability,
    shift_matvec_counts,
)

T = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: its ops are on 144-row
    signals, where more threads only add contention (and, beside other
    test workers on the same cores, busy-waiting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _path_adjacency(t: int) -> np.ndarray:
    a = np.zeros((t, t))
    idx = np.arange(t - 1)
    a[idx, idx + 1] = a[idx + 1, idx] = 1.0
    return a


@pytest.fixture(scope="module")
def product():
    """The reference's ``product_setting`` and the port's copy of it."""
    gs = jgraph.connected_sensor_graph(jax.random.PRNGKey(7), n=24, sigma=0.45, kappa=0.5)
    ag = np.asarray(gs.adjacency, np.float64)
    at = _path_adjacency(T)
    n = ag.shape[0] * T
    a1 = np.kron(ag, np.eye(T))
    a2 = np.kron(np.eye(ag.shape[0]), at)
    cg = np.asarray(gs.coords)
    coords = np.column_stack([np.repeat(cg, T, axis=0), np.tile(np.arange(T) / T, ag.shape[0])[:, None]])
    g1 = jgraph.SensorGraph(adjacency=jnp.asarray(a1), coords=jnp.asarray(coords))
    g2 = jgraph.SensorGraph(adjacency=jnp.asarray(a2), coords=jnp.asarray(coords))
    lm1, lm2 = float(g1.lmax_bound()), float(g2.lmax_bound())
    cg1 = jcheb.cheb_coefficients([jmult.heat(0.6), jmult.tikhonov(1.0, 1)], 8, lm1)
    cg2 = jcheb.cheb_coefficients([jmult.heat(1.2)], 5, lm2)
    coeffs = jcheb.separable_joint_coefficients([cg1, cg2])
    jf = JFilter.from_shifts([g1, g2], coeffs, lmaxes=[lm1, lm2])
    f = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (n,)))
    adjs = [np.asarray(g1.adjacency), np.asarray(g2.adjacency)]
    tf = interop.joint_filter_from_numpy(adjs, np.asarray(g1.coords), jf.coeffs,
                                         jf.shift_lmaxes, "cpu")
    return {"jf": jf, "tf": tf, "f": f, "ag": ag, "at": at, "factors": (cg1, cg2),
            "adjs": adjs, "coords": np.asarray(g1.coords)}


def _kron_oracle(filt, f, ag, at):
    """Exact two-shift apply via the kron eigenbasis (``tests/test_multishift.py:96-111``)."""
    lg = np.diag(np.asarray(ag).sum(1)) - ag
    lt = np.diag(at.sum(1)) - at
    wg, ug = np.linalg.eigh(lg)
    wt, ut = np.linalg.eigh(lt)
    u = np.kron(ug, ut)
    vals = tcheb.cheb_eval_joint(filt.coeffs, [np.maximum(wg, 0.0), np.maximum(wt, 0.0)],
                                 list(filt.shift_lmaxes))
    fe = u.T @ np.asarray(f, np.float64)
    return np.stack([u @ (vals[j].reshape(-1) * fe) for j in range(filt.eta)])


BACKENDS = [
    ("dense", {}),
    ("bsr", {"fuse": True}),
    ("bsr", {"fuse": False}),
    ("bsr", {"block_size": 16}),
    ("halo", {"n_parts": 4}),
    ("halo", {"n_parts": 8}),
]
BACKEND_IDS = ["dense", "bsr-fused", "bsr-stepwise", "bsr-b16", "halo-4", "halo-8"]


def _mesh_opts(opts):
    """Backend options with ``n_parts=`` turned into an explicit CPU
    ``StackedMesh`` of that many ranks."""
    if "n_parts" in opts:
        return {"mesh": collectives.StackedMesh(opts["n_parts"], "cpu")}
    return dict(opts)


# ---- coefficients ---------------------------------------------------------


def test_joint_coefficients_match_reference(product):
    cg1, cg2 = product["factors"]
    np.testing.assert_allclose(tcheb.separable_joint_coefficients([cg1, cg2]),
                               jcheb.separable_joint_coefficients([cg1, cg2]), rtol=0, atol=1e-12)
    c = product["jf"].coeffs
    np.testing.assert_allclose(tcheb.joint_gram_coefficients(c),
                               jcheb.joint_gram_coefficients(c), rtol=0, atol=1e-12)
    rng = np.random.default_rng(3)
    for shape_a, shape_b in (((4, 3), (2, 5)), ((3, 2, 4), (2, 3, 2)), ((5,), (4,))):
        a, b = rng.standard_normal(shape_a), rng.standard_normal(shape_b)
        np.testing.assert_allclose(tcheb.joint_product_coefficients(a, b),
                                   jcheb.joint_product_coefficients(a, b), rtol=0, atol=1e-12)
    # R = 1 reduces to the single-shift gram series
    np.testing.assert_allclose(tcheb.joint_gram_coefficients(cg1),
                               tcheb.gram_coefficients(cg1), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="share eta"):
        tcheb.separable_joint_coefficients([np.ones((2, 3)), np.ones((3, 3))])


def test_joint_filter_from_numpy_carries_the_reference(product):
    jf, tf = product["jf"], product["tf"]
    np.testing.assert_array_equal(tf.coeffs, jf.coeffs)
    np.testing.assert_array_equal(tf.gram_coeffs, jf.gram_coeffs)
    assert tf.shift_lmaxes == jf.shift_lmaxes and tf.lmax == jf.lmax
    assert tf.orders == jf.orders == (8, 5) and tf.n_shifts == jf.n_shifts == 2
    assert tf.eta == jf.eta == 2
    assert len(tf.shift_graphs) == 2 and tf.shift_graphs[0] is tf.graph
    for g, a in zip(tf.shift_graphs, product["adjs"]):
        np.testing.assert_array_equal(g.adjacency.numpy(), np.asarray(a, np.float32))
    assert abs(tf.operator_norm_bound() - jf.operator_norm_bound()) <= 1e-6 * jf.operator_norm_bound()


def test_from_shifts_checks_match_reference(product):
    jf, tf = product["jf"], product["tf"]
    g_small = interop.sensor_graph_from_numpy(np.zeros((5, 5)), None, "cpu")
    jg_small = jgraph.SensorGraph(adjacency=jnp.zeros((5, 5)))
    cases = [
        (lambda G, shifts: G.from_shifts([shifts[0], g_small if G is GraphFilter else jg_small],
                                         jf.coeffs)),
        (lambda G, shifts: G.from_shifts(list(shifts), np.ones((2, 3, 3, 3)))),
        (lambda G, shifts: G.from_shifts(list(shifts), jf.coeffs, lmaxes=[1.0])),
        (lambda G, shifts: G.from_shifts([], jf.coeffs)),
    ]
    for case in cases:
        with pytest.raises(ValueError) as got:
            case(GraphFilter, tf.shift_graphs)
        with pytest.raises(ValueError) as want:
            case(JFilter, jf.shift_graphs)
        assert str(got.value) == str(want.value)
    # an (M_1+1, M_2+1) tensor is promoted to eta = 1
    one = GraphFilter.from_shifts(tf.shift_graphs, jf.coeffs[0], lmaxes=tf.shift_lmaxes)
    assert one.eta == 1 and one.orders == (8, 5)
    np.testing.assert_array_equal(one.gram_coeffs,
                                  JFilter.from_shifts(jf.shift_graphs, jf.coeffs[0],
                                                      lmaxes=jf.shift_lmaxes).gram_coeffs)
    # default lmaxes: each graph's Anderson--Morley bound
    default = GraphFilter.from_shifts(tf.shift_graphs, jf.coeffs)
    np.testing.assert_allclose(default.shift_lmaxes, jf.shift_lmaxes, rtol=1e-6)


def _refusals(filt) -> list[str]:
    """The errors of ``bind``, ``order`` and a scalar ``order=`` words
    query on a multi-shift filter."""
    msgs = []
    for call, match in ((lambda: filt.bind(filt.graph), "single-shift"),
                        (lambda: filt.order, "per-shift orders"),
                        (lambda: filt.messages_per_apply(4), "orders=")):
        with pytest.raises(ValueError, match=match) as exc:
            call()
        msgs.append(str(exc.value))
    return msgs


def test_bind_and_order_refuse_a_multi_shift_filter(product):
    tf = product["tf"]
    assert _refusals(tf) == _refusals(product["jf"])
    # a single-shift filter's shift tuple is its graph
    single = GraphFilter.from_coefficients(np.ones((1, 3)), 2.0, graph=tf.graph)
    assert single.shift_graphs == (tf.graph,) and single.shift_lmaxes == (2.0,)
    assert single.orders == (2,) and single.n_shifts == 1


# ---- the joint apply on each backend -----------------------------------------


@pytest.mark.parametrize("backend,opts", BACKENDS, ids=BACKEND_IDS)
def test_two_shift_apply_matches_kron_oracle_and_reference(product, backend, opts):
    jf, tf, f = product["jf"], product["tf"], product["f"]
    oracle = _kron_oracle(tf, f, product["ag"], product["at"])
    want = np.asarray(jf.apply(jnp.asarray(f), backend="dense"))
    got = tf.apply(torch.as_tensor(f), backend=backend, **_mesh_opts(opts))
    assert got.shape == (tf.eta, f.shape[0]) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy().astype(np.float64) - oracle)) < 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,opts", BACKENDS, ids=BACKEND_IDS)
def test_two_shift_adjoint_identity_and_reference(product, backend, opts):
    jf, tf, f = product["jf"], product["tf"], product["f"]
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (tf.eta, f.shape[0])))
    kw = _mesh_opts(opts)
    out = tf.apply(torch.as_tensor(f), backend=backend, **kw)
    back = tf.adjoint(torch.as_tensor(a), backend=backend, **kw)
    lhs = float(np.vdot(out.numpy().astype(np.float64), a))
    rhs = float(np.vdot(f.astype(np.float64), back.numpy().astype(np.float64)))
    np.testing.assert_allclose(lhs, rhs, rtol=2e-5)
    want = np.asarray(jf.adjoint(jnp.asarray(a), backend="dense"))
    np.testing.assert_allclose(back.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,opts", BACKENDS, ids=BACKEND_IDS)
def test_two_shift_gram_equals_composition(product, backend, opts):
    tf, f = product["tf"], torch.as_tensor(product["f"])
    kw = _mesh_opts(opts)
    composed = tf.adjoint(tf.apply(f, backend=backend, **kw), backend=backend, **kw)
    direct = tf.gram(f, backend=backend, **kw)
    np.testing.assert_allclose(direct.numpy(), composed.numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("backend,opts", [("dense", {}), ("bsr", {}), ("halo", {"n_parts": 4})],
                         ids=["dense", "bsr", "halo-4"])
def test_two_shift_panel_matches_columns(product, backend, opts):
    tf, f = product["tf"], torch.as_tensor(product["f"])
    kw = _mesh_opts(opts)
    panel = torch.stack([f, 2.0 * f, f - 1.0], dim=1)
    out = tf.apply(panel, backend=backend, **kw)
    for i in range(3):
        np.testing.assert_allclose(out[:, :, i].numpy(),
                                   tf.apply(panel[:, i], backend=backend, **kw).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_joint_recurrence_for_three_shifts_matches_tensor_oracle():
    """R = 3 on a product of three paths (every level an outer one but
    the last): ``cheb_apply_joint`` and its adjoint against the kron
    eigenbasis, and the ``inner=`` hook against the default."""
    sizes = (3, 4, 5)
    adjs = []
    for r, t in enumerate(sizes):
        eyes = [np.eye(s) for s in sizes]
        eyes[r] = _path_adjacency(t)
        adjs.append(np.kron(np.kron(eyes[0], eyes[1]), eyes[2]))
    laps = [torch.as_tensor(np.diag(a.sum(1)) - a) for a in adjs]
    lmaxes = [4.0, 4.0, 4.0]
    rng = np.random.default_rng(5)
    coeffs = rng.standard_normal((2, 4, 3, 5)) / 4
    f = torch.as_tensor(rng.standard_normal((60, 2)))
    mvs = [lambda v, m=m: torch.tensordot(m, v, dims=1) for m in laps]
    got = tcheb.cheb_apply_joint(mvs, f, coeffs, lmaxes)
    ws, us = zip(*(np.linalg.eigh(np.diag(_path_adjacency(t).sum(1)) - _path_adjacency(t))
                   for t in sizes))
    u = np.kron(np.kron(us[0], us[1]), us[2])
    vals = tcheb.cheb_eval_joint(coeffs, [np.maximum(w, 0.0) for w in ws], lmaxes)
    fe = u.T @ f.numpy()
    want = np.stack([u @ (vals[j].reshape(-1, 1) * fe) for j in range(2)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    hooked = tcheb.cheb_apply_joint(
        mvs, f, coeffs, lmaxes, inner=lambda v, c: tcheb.cheb_apply(mvs[-1], v, c, lmaxes[-1]))
    np.testing.assert_allclose(hooked.numpy(), got.numpy(), rtol=0, atol=1e-12)
    a = torch.as_tensor(rng.standard_normal((2, 60, 2)))
    back = tcheb.cheb_adjoint_apply_joint(mvs, a, coeffs, lmaxes)
    np.testing.assert_allclose(float((got * a).sum()), float((f * back).sum()), rtol=1e-10)
    with pytest.raises(ValueError, match="ndim R\\+1"):
        tcheb.cheb_apply_joint(mvs[:2], f, coeffs, lmaxes[:2])
    with pytest.raises(ValueError, match="lmaxes"):
        tcheb.cheb_apply_joint(mvs, f, coeffs, lmaxes[:2])


def test_bsr_joint_state_shares_one_layout(product):
    tf = product["tf"]
    state = tf.prepare_backend("bsr")
    assert len(state.bells) == 2 and state.n_pad == state.bells[1].n == state.bells[0].n
    # one RCB order from the first shift's coordinates, as the reference's
    want = jgraph.spatial_partition_order(product["coords"], tf.graph.n_vertices // 8)
    np.testing.assert_array_equal(state.perm.numpy(), want)


# ---- plans and words ------------------------------------------------------


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_shift_partition_plans_match_reference_bitwise(product, n_parts):
    want = jdist.build_shift_partition_plans(product["adjs"], product["coords"], n_parts)
    got = tdist.build_shift_partition_plans(
        [torch.as_tensor(a) for a in product["adjs"]], torch.as_tensor(product["coords"]),
        n_parts, device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.order, w.order)
        np.testing.assert_array_equal(g.boundary_counts, w.boundary_counts)
        np.testing.assert_array_equal(g.pair_counts, w.pair_counts)
        assert (g.n_local, g.n, g.n_boundary, g.halo_words) == (
            w.n_local, w.n, w.n_boundary, w.halo_words)
        for name in ("l_own", "l_halo", "send_idx"):
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(w, name)))
    assert all(np.array_equal(p.order, got[0].order) for p in got)


@pytest.mark.parametrize("n_parts", [4, 8])
def test_messages_per_apply_is_the_reference_per_shift_sum(product, n_parts):
    jf, tf = product["jf"], product["tf"]
    plans = jdist.build_shift_partition_plans(product["adjs"], product["coords"], n_parts)
    jctx = jdist.MultiShiftGraphContext(plans=tuple(plans), mesh=None, axis="i",
                                        lmaxes=tuple(jf.shift_lmaxes))
    mesh = collectives.StackedMesh(n_parts, "cpu")
    for orders in (jf.orders, (jf.orders[0], 0), (0, jf.orders[1]), (16, 10)):
        want = jctx.messages_per_apply(shift_matvec_counts(orders))
        assert want == sum(c * p.halo_words for c, p in zip(shift_matvec_counts(orders), plans))
        assert tf.messages_per_apply(orders=orders, backend="halo", mesh=mesh) == want
    assert tf.messages_per_apply(backend="halo", mesh=mesh) > 0
    assert tf.messages_per_apply(backend="dense") == tf.messages_per_apply(backend="bsr") == 0


def test_stacked_mesh_exchanges_follow_shift_matvec_counts(product):
    tf, f = product["tf"], torch.as_tensor(product["f"])
    p = 4
    mesh = collectives.StackedMesh(p, "cpu")
    ctx = tf.prepare_backend("halo", mesh=mesh)
    assert isinstance(ctx, tdist.MultiShiftGraphContext)
    counts = shift_matvec_counts(tf.orders)
    assert counts == (8, 45)
    panel = torch.stack([f, f - 1.0], dim=1)
    # apply: one exchange per matvec of each shift, each moving that
    # shift's padded send buffer P (P-1) max_halo_r lanes of F values
    mesh.reset_counts()
    tf.apply(panel, backend="halo", mesh=mesh)
    assert mesh.calls["all_to_all"] == sum(counts)
    assert mesh.elements["all_to_all"] == sum(
        c * p * (p - 1) * plan.max_halo * 2 for c, plan in zip(counts, ctx.plans))
    # gram: the joint series of orders 2M_r
    mesh.reset_counts()
    tf.gram(panel, backend="halo", mesh=mesh)
    assert mesh.calls["all_to_all"] == sum(shift_matvec_counts(tuple(2 * m for m in tf.orders)))
    # adjoint: the same counts, length-eta messages
    mesh.reset_counts()
    tf.adjoint(tf.apply(panel, backend="dense"), backend="halo", mesh=mesh)
    assert mesh.calls["all_to_all"] == sum(counts)
    assert mesh.elements["all_to_all"] == sum(
        c * p * (p - 1) * plan.max_halo * 2 * tf.eta for c, plan in zip(counts, ctx.plans))


# ---- capabilities ---------------------------------------------------------


def test_multi_shift_capability_matrix_matches_reference(product):
    want = {"dense": True, "bsr": True, "halo": True,
            "allgather": False, "grid": False, "matvec": False}
    assert set(available_backends()) == set(want)
    for name, flag in want.items():
        assert backend_supports_multi_shift(name) == jregistry.backend_supports_multi_shift(name)
        assert backend_capabilities(name).multi_shift == flag, name
    jf, tf, f = product["jf"], product["tf"], product["f"]
    for name in ("allgather", "grid", "matvec"):
        with pytest.raises(ValueError, match=rf"'{name}'.*'multi_shift'") as got:
            tf.apply(torch.as_tensor(f), backend=name)
        with pytest.raises(ValueError) as want_exc:
            jf.apply(jnp.asarray(f), backend=name)
        assert str(got.value) == str(want_exc.value)
    with pytest.raises(ValueError) as got:
        require_capability("allgather", "multi_shift")
    with pytest.raises(ValueError) as want_exc:
        jregistry.require_capability("allgather", "multi_shift")
    assert str(got.value) == str(want_exc.value)
    for name in ("bsr", "dense", "halo"):
        assert name in str(got.value)


def test_allgather_never_receives_a_multi_shift_context(product):
    tf, f = product["tf"], torch.as_tensor(product["f"])
    mesh = collectives.StackedMesh(4, "cpu")
    ctx = tf.prepare_backend("halo", mesh=mesh)
    with pytest.raises(ValueError, match="'allgather'.*'multi_shift'"):
        tf.apply(f, backend="allgather", mesh=mesh)
    from repro_torch.filters import get_backend

    with pytest.raises(ValueError, match="'allgather'.*'multi_shift'"):
        get_backend("allgather").apply(tf, ctx, f)
    assert tf.prepare_backend("halo", mesh=mesh) is ctx


# ---- solvers ----------------------------------------------------------------


def test_two_shift_preconditioner_and_pcg_match_reference(product):
    jf, tf, f = product["jf"], product["tf"], product["f"]
    jprob = js.GramProblem(filt=jf, b=jnp.asarray(f), reg=1e-3)
    tprob = ts.GramProblem(filt=tf, b=torch.as_tensor(f), reg=1e-3)
    jpre = js.cheb_preconditioner(jprob, order=6)
    tpre = ts.cheb_preconditioner(tprob, order=6)
    assert tpre.orders == jpre.orders and len(tpre.orders) == 2
    assert tpre.rate == jpre.rate < 1.0
    np.testing.assert_array_equal(tpre.coeffs, jpre.coeffs)
    want = js.conjugate_gradient(jprob, n_iters=100, tol=1e-6, preconditioner=jpre)
    for backend in ("dense", "bsr"):
        pre = ts.cheb_preconditioner(tprob, order=6, backend=backend)
        got = ts.conjugate_gradient(tprob, n_iters=100, tol=1e-6, backend=backend,
                                    preconditioner=pre)
        assert got.converged and want.converged and got.method == "pcg"
        # ROADMAP C: float32 rounding moves CG counts by a few on both sides
        assert abs(got.iterations - want.iterations) <= 2, (got.iterations, want.iterations)
        # x is O(1e3) at reg = 1e-3: the reference's PCG tolerance, rtol
        # 1e-3 (tests/test_multishift.py), with atol relative to |x|
        scale = float(np.abs(np.asarray(want.x)).max())
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-3, atol=1e-4 * scale)


def test_two_shift_cheb_inverse_matches_reference(product):
    """At reg = 0.1 (at 1e-3 the fixed point stalls near 4e-5 in float32
    on both sides): the order-12 joint fit, 7 sweeps to 1e-6."""
    jf, tf, f = product["jf"], product["tf"], product["f"]
    jprob = js.GramProblem(filt=jf, b=jnp.asarray(f), reg=0.1)
    tprob = ts.GramProblem(filt=tf, b=torch.as_tensor(f), reg=0.1)
    want = js.cheb_inverse(jprob, order=6, n_iters=100, tol=1e-6)
    scale = float(np.abs(np.asarray(want.x)).max())
    for backend in ("dense", "bsr"):
        got = ts.cheb_inverse(tprob, order=6, n_iters=100, tol=1e-6, backend=backend)
        assert got.converged and want.converged
        assert got.aux.orders == want.aux.orders and got.aux.rate == want.aux.rate
        assert abs(got.iterations - want.iterations) <= 2, (got.iterations, want.iterations)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-4,
                                   atol=1e-5 * scale)
    mesh = collectives.StackedMesh(4, "cpu")
    words = tf.messages_per_apply(orders=(16, 10), backend="halo", mesh=mesh) + \
        tf.messages_per_apply(orders=got.aux.orders, backend="halo", mesh=mesh)
    halo = ts.cheb_inverse(tprob, order=6, n_iters=3, tol=None, backend="halo", mesh=mesh)
    assert halo.messages_per_iteration == words > 0


def test_pcg_identity_preconditioner_matches_plain(product):
    tf, f = product["tf"], product["f"]
    prob = ts.GramProblem(filt=tf, b=torch.as_tensor(f), reg=1e-3)
    plain = ts.conjugate_gradient(prob, n_iters=60, tol=1e-8)
    pcg = ts.conjugate_gradient(prob, n_iters=60, tol=1e-8, preconditioner=lambda v: v)
    assert plain.method == "cg" and pcg.method == "pcg"
    np.testing.assert_allclose(pcg.x.numpy(), plain.x.numpy(), rtol=1e-5, atol=1e-6)
