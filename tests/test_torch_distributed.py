"""Port parity for the distributed layer: ``repro_torch.core.collectives``,
``repro_torch.core.distributed`` and the ``halo``, ``allgather`` and
``grid`` backends, held against the JAX package on the same numpy inputs.

* Partition plans equal the reference's bit for bit (``np.array_equal``).
* Words are platform-free and equal the live reference's exactly, then
  ``BENCH_pr10.json``'s numbers as a second check.
* Schedules run on a ``StackedMesh`` on the CPU (the reference's tests
  run theirs with vmap-as-mesh collectives) and match the reference's
  dense oracle within the reference tests' tolerances:
  ``tests/test_overlap.py`` 1e-5, ``tests/test_filters.py`` apply and
  adjoint 1e-5, gram against the composition 5e-4, the eigh oracle 1e-4
  (gram 2e-4).
* One test spawns 4 gloo ranks and holds ``GroupMesh`` against
  ``StackedMesh(4)`` within 1e-6 with equal exchange counts.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chebyshev as jcheb
from repro.core import distributed as jdist
from repro.core import graph as jgraph
from repro.core import multipliers as jmult
from repro.core import operators as jops
from repro.filters import GraphFilter as JFilter
from repro.filters import get_backend as jget_backend
from repro_torch import interop
from repro_torch import solvers as ts
from repro_torch.core import collectives
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.core import multipliers as tmult
from repro_torch.filters import GraphFilter, backend_capabilities, get_backend

SRC = Path(__file__).resolve().parents[1] / "src"


def _random_graph(n: int, seed: int):
    """Connected weighted random graph + coords (ER edges over a ring), as
    ``tests/test_overlap.py`` draws it."""
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


def _bench_graph(key, **kw):
    """A reference graph as ``BENCH_pr10.json`` drew it: jax changed the
    default of ``jax_threefry_partitionable`` to True after the jax
    version that record was taken with (0.4.37), which changes every
    ``jax.random`` draw; the old stream reproduces the record's graphs."""
    with jax.threefry_partitionable(False):
        return jgraph.connected_sensor_graph(key, **kw)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


# ---- collectives ---------------------------------------------------------


def test_stacked_mesh_collectives_and_counts():
    p = 4
    mesh = collectives.StackedMesh(p, "cpu")
    x = torch.arange(p * p * 3 * 2, dtype=torch.float32).reshape(p, p, 3, 2)
    recv = mesh.all_to_all(x)
    for a in range(p):
        for b in range(p):
            assert torch.equal(recv[a, b], x[b, a])
    assert torch.equal(mesh.all_to_all(x, async_op=True).wait(), recv)
    slabs = torch.randn(p, 5, 2)
    full = mesh.all_gather(slabs)
    assert full.shape == (p, p * 5, 2)
    for a in range(p):
        assert torch.equal(full[a], slabs.reshape(p * 5, 2))
    fwd, bwd = mesh.shift_fwd(slabs), mesh.shift_bwd(slabs)
    assert torch.equal(fwd[1:], slabs[:-1]) and not fwd[0].any()
    assert torch.equal(bwd[:-1], slabs[1:]) and not bwd[-1].any()
    assert mesh.calls == {"all_to_all": 2, "all_gather": 1, "shift": 2}
    assert mesh.elements["all_to_all"] == 2 * p * (p - 1) * 6
    assert mesh.elements["all_gather"] == p * (p - 1) * 10
    assert mesh.elements["shift"] == 2 * (p - 1) * 10
    assert torch.equal(mesh.rank_index(), torch.arange(p))
    with pytest.raises(ValueError, match="leading rank axis"):
        mesh.all_to_all(x[:2])
    mesh.reset_counts()
    assert not mesh.calls and not mesh.elements


def test_default_mesh_is_stacked_on_the_graph_device():
    a, coords = _random_graph(40, 0)
    g = interop.sensor_graph_from_numpy(a, coords, "cpu")
    filt = GraphFilter.from_coefficients(np.ones((1, 4)), 8.0, graph=g)
    one = filt.prepare_backend("halo")
    four = filt.prepare_backend("halo", n_parts=4)
    assert isinstance(one.mesh, collectives.StackedMesh) and one.mesh.n_parts == 1
    assert four.mesh.n_parts == 4 and four.mesh.device == torch.device("cpu")
    # halo and allgather share one prepared plan per mesh choice
    assert filt.prepare_backend("allgather", n_parts=4) is four


# ---- partition plans, bit for bit ----------------------------------------


@pytest.mark.parametrize("n,n_parts,seed", [(60, 2, 10), (90, 4, 11), (90, 8, 12),
                                            (45, 3, 13), (96, 1, 14)])
def test_plan_tables_match_reference_bitwise(n, n_parts, seed):
    a, coords = _random_graph(n, seed)
    want = jdist.build_partition_plan(a, coords, n_parts)
    got = tdist.build_partition_plan(a, coords, n_parts, device="cpu")
    for name in ("order", "boundary_counts", "pair_counts"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    for name in ("n_boundary", "halo_words", "n_local", "n", "n_parts"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.l_own.dtype == torch.float32 and got.send_idx.dtype == torch.int64
    for name in ("l_own", "l_halo", "send_idx"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    assert np.array_equal(tdist.plan_row_slabs(got).numpy(),
                          np.asarray(jdist.plan_row_slabs(want)))
    assert np.array_equal(got.owner_of(), want.owner_of())
    counts = got.vertex_send_counts(a)
    assert np.array_equal(counts, want.vertex_send_counts(a))
    assert int(counts.sum()) == got.halo_words
    support = np.zeros(n, dtype=bool)
    support[[0, n // 2]] = True
    for order in (1, 4, 20):
        assert (got.delta_halo_words(a, support, order)
                == want.delta_halo_words(a, support, order))


@pytest.mark.parametrize("n,bench_halo,bench_allgather",
                         [(250, 3960, 35840), (500, 5020, 70560), (1000, 5320, 140000)])
def test_comm_scaling_words_match_reference(n, bench_halo, bench_allgather):
    """``benchmarks/run.py::tab_comm_scaling`` graphs, P = 8, M = 20."""
    order = 20
    kappa = 0.075 * float(np.sqrt(500.0 / n))
    g = _bench_graph(jax.random.PRNGKey(n), n=n, sigma=kappa * 0.99, kappa=kappa)
    plan = jdist.build_partition_plan(g.adjacency, g.coords, 8)  # the live reference
    tg = interop.sensor_graph_from_numpy(np.asarray(g.adjacency), np.asarray(g.coords), "cpu")
    filt = GraphFilter.from_coefficients(np.ones((1, order + 1)), 8.0, graph=tg)
    halo = filt.messages_per_apply(backend="halo", n_parts=8)
    allgather = filt.messages_per_apply(backend="allgather", n_parts=8)
    assert halo == order * plan.halo_words
    assert allgather == order * plan.n_local * 8 * 7
    assert halo <= 2 * order * tg.n_edges
    # second: the committed benchmark record
    assert (halo, allgather) == (bench_halo, bench_allgather)


# ---- the halo schedules --------------------------------------------------


@pytest.mark.parametrize("n,n_parts,order,eta,seed", [
    (60, 2, 5, 1, 10),
    (90, 4, 16, 2, 11),
    (90, 8, 21, 2, 12),
    (45, 3, 2, 1, 13),  # smallest order that enters the looped steps
    (45, 3, 1, 1, 14),  # order 1: no exchange after T_0's
])
def test_overlapped_apply_matches_dense_and_serial(n, n_parts, order, eta, seed):
    """The cases of ``tests/test_overlap.py``: overlapped and serial
    schedules against the reference's dense oracle within 1e-5, and each
    makes exactly M exchanges."""
    a, coords = _random_graph(n, seed)
    lap = np.diag(a.sum(axis=1)) - a
    lmax = float(np.linalg.eigvalsh(lap).max()) * 1.01
    mults = [lambda x: np.exp(-(j + 1) * x / 4.0) for j in range(eta)]
    coeffs = jnp.asarray(jcheb.cheb_coefficients(mults, order, lmax), jnp.float32)
    f = np.random.default_rng(seed + 1).normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(jcheb.cheb_apply_dense(jnp.asarray(lap, jnp.float32), jnp.asarray(f),
                                             coeffs, lmax))
    mesh = collectives.StackedMesh(n_parts, "cpu")
    ctx = tdist.DistributedGraphContext(
        plan=tdist.build_partition_plan(a, coords, n_parts, device="cpu"), mesh=mesh)
    sharded = ctx.scatter_signal(torch.as_tensor(f))
    outs = {}
    for overlap in (True, False):
        mesh.reset_counts()
        out = ctx.cheb_apply(sharded, np.asarray(coeffs), lmax, overlap=overlap)
        outs[overlap] = ctx.gather_signal(out)
        assert mesh.calls["all_to_all"] == order, (overlap, dict(mesh.calls))
        _close(outs[overlap], want, 1e-5)
    _close(outs[True], outs[False].numpy(), 1e-5)
    # the stacked mesh's default is the serial schedule
    assert not mesh.overlaps
    assert torch.equal(ctx.gather_signal(ctx.cheb_apply(sharded, np.asarray(coeffs), lmax)),
                       outs[False])


@pytest.fixture(scope="module")
def sensor_setting():
    """``tests/test_filters.py::sensor_setting`` and its port twin."""
    g = jgraph.connected_sensor_graph(jax.random.PRNGKey(1), n=96, sigma=0.17, kappa=0.18)
    jf = JFilter.from_multipliers([jmult.tikhonov(1.0, 1), jmult.heat(0.5)], order=16, graph=g)
    f = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (g.n_vertices, 8)))
    tg = interop.sensor_graph_from_numpy(np.asarray(g.adjacency), np.asarray(g.coords), "cpu")
    return jf, interop.filter_from_numpy(jf.coeffs, jf.lmax, tg), f


@pytest.mark.parametrize("n_parts", [4, 8])
@pytest.mark.parametrize("backend,opts", [("halo", {"overlap": True}),
                                          ("halo", {"overlap": False}), ("allgather", {})],
                         ids=["halo", "halo-serial", "allgather"])
@pytest.mark.parametrize("batched", [True, False], ids=["2d", "1d"])
def test_graph_filter_parity_with_reference_dense(sensor_setting, backend, opts, batched,
                                                  n_parts):
    jf, tf, f = sensor_setting
    x = f if batched else f[:, 0]
    mesh = collectives.StackedMesh(n_parts, "cpu")
    want = jf.apply(jnp.asarray(x), backend="dense")
    got = tf.apply(torch.as_tensor(x), backend=backend, mesh=mesh, **opts)
    assert got.shape == (tf.eta,) + x.shape
    _close(got, want, 1e-5)
    assert mesh.calls[{"halo": "all_to_all", "allgather": "all_gather"}[backend]] == tf.order
    a = np.asarray(want)
    back = tf.adjoint(torch.as_tensor(a), backend=backend, mesh=mesh)
    assert back.shape == x.shape
    _close(back, jf.adjoint(jnp.asarray(a), backend="dense"), 1e-5)
    gram = tf.gram(torch.as_tensor(x), backend=backend, mesh=mesh, **opts)
    composed = tf.adjoint(tf.apply(torch.as_tensor(x), backend=backend, mesh=mesh, **opts),
                          backend=backend, mesh=mesh)
    _close(gram, composed.numpy(), 5e-4)
    _close(gram, jf.gram(jnp.asarray(x), backend="dense"), 1e-5)


def test_reference_axis_keyword_reuses_the_prepared_plan(sensor_setting):
    """The reference's ``axis=`` names a shard_map mesh axis; the port's
    meshes have none, so the keyword is taken and ignored and keeps out
    of the state key: no second partition plan for the same mesh."""
    _, tf, f = sensor_setting
    mesh = collectives.StackedMesh(4, "cpu")
    for backend in ("halo", "allgather"):
        assert (tf.prepare_backend(backend, mesh=mesh)
                is tf.prepare_backend(backend, mesh=mesh, axis="x"))
    x = torch.as_tensor(f)
    assert torch.equal(tf.apply(x, backend="halo", mesh=mesh, axis="x"),
                       tf.apply(x, backend="halo", mesh=mesh))


def test_adjoint_makes_m_exchanges(sensor_setting):
    _, tf, f = sensor_setting
    mesh = collectives.StackedMesh(8, "cpu")
    a = tf.apply(torch.as_tensor(f), backend="dense")
    tf.adjoint(a, backend="halo", mesh=mesh)
    assert dict(mesh.calls) == {"all_to_all": tf.order}
    plan = tf.prepare_backend("halo", mesh=mesh).plan
    # every exchange moves the padded send buffer: P (P-1) max_halo lanes
    # of eta * F values, against halo_words * eta * F useful ones
    per = 8 * 7 * plan.max_halo * tf.eta * f.shape[1]
    assert mesh.elements["all_to_all"] == tf.order * per
    assert plan.halo_words <= 8 * 7 * plan.max_halo


POLY_BANK = [
    lambda x: 0.3 + 0.1 * np.asarray(x, np.float64),
    lambda x: 1.0 - 0.25 * np.asarray(x, np.float64) + 0.05 * np.asarray(x, np.float64) ** 2,
]


@pytest.mark.parametrize("backend", ["halo", "allgather", "grid"])
def test_distributed_backends_match_exact_oracle(backend):
    """Polynomial multipliers make the expansion exact: apply, adjoint and
    gram against the eigh oracle (``tests/test_filters.py:146-191``)."""
    if backend == "grid":
        jg, lmax = jgraph.grid_graph(16), 8.0
    else:
        jg = jgraph.connected_sensor_graph(jax.random.PRNGKey(9), n=96, sigma=0.17, kappa=0.18)
        lmax = float(jg.lmax_bound())
    lap = np.asarray(jg.laplacian(), np.float64)
    tg = interop.sensor_graph_from_numpy(np.asarray(jg.adjacency), np.asarray(jg.coords), "cpu")
    filt = GraphFilter.from_multipliers(POLY_BANK, order=8, graph=tg, lmax=lmax)
    mesh = collectives.StackedMesh(4, "cpu")
    f = np.asarray(jax.random.normal(jax.random.PRNGKey(10), (tg.n_vertices, 4)))
    got = filt.apply(torch.as_tensor(f), backend=backend, mesh=mesh)
    _close(got, jops.exact_union_apply(lap, POLY_BANK, f), 1e-4)
    mats = jops.exact_multiplier_matrix(lap, POLY_BANK)
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (filt.eta, tg.n_vertices, 4)))
    got = filt.adjoint(torch.as_tensor(a), backend=backend, mesh=mesh)
    _close(got, np.einsum("jnm,jmf->nf", mats, a.astype(np.float64)), 1e-4)
    got = filt.gram(torch.as_tensor(f), backend=backend, mesh=mesh)
    _close(got, sum(m @ (m @ f.astype(np.float64)) for m in mats), 2e-4)


# ---- the grid backend ----------------------------------------------------


@pytest.fixture(scope="module")
def grid_setting():
    """``tests/test_filters.py::grid_setting`` and its port twin."""
    g = jgraph.grid_graph(16)
    jf = JFilter.from_multipliers([jmult.tikhonov(1.0, 1), jmult.heat(0.5)], order=12,
                                  graph=g, lmax=8.0)
    f = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (g.n_vertices, 4)))
    tg = tgraph.grid_graph(16, device="cpu")
    assert np.array_equal(tg.adjacency.numpy(), np.asarray(g.adjacency))
    assert np.array_equal(tg.coords.numpy(), np.asarray(g.coords))
    return jf, interop.filter_from_numpy(jf.coeffs, jf.lmax, tg), f


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("batched", [True, False], ids=["2d", "1d"])
def test_grid_backend_matches_reference_dense(grid_setting, depth, batched):
    jf, tf, f = grid_setting
    x = f if batched else f[:, 0]
    mesh = collectives.StackedMesh(4, "cpu")
    got = tf.apply(torch.as_tensor(x), backend="grid", mesh=mesh, depth=depth)
    want = jf.apply(jnp.asarray(x), backend="dense")
    _close(got, want, 1e-5)
    m = tf.order
    # neighbour rounds: one for T_1, then one per block of `depth` orders
    assert mesh.calls["shift"] == 2 + 2 * math.ceil((m - 1) / depth)
    mesh.reset_counts()
    a = np.asarray(want)
    _close(tf.adjoint(torch.as_tensor(a), backend="grid", mesh=mesh, depth=depth),
           jf.adjoint(jnp.asarray(a), backend="dense"), 1e-5)
    assert mesh.calls["shift"] == 2 * m  # one slab matvec per order
    words = tf.messages_per_apply(backend="grid", mesh=mesh, depth=depth)
    assert words == m * 2 * 3 * 16


def test_grid_slab_and_allgather_matvecs_match_dense():
    g = tgraph.grid_graph(8, device="cpu")
    mesh = collectives.StackedMesh(4, "cpu")
    x = torch.randn(64, 3, generator=torch.Generator().manual_seed(0))
    want = g.laplacian() @ x
    slabs = x.reshape(4, 16, 3)
    for mv in (tdist.grid_slab_matvec, tdist.grid_allgather_matvec):
        got = mv(slabs, side=8, mesh=mesh).reshape(64, 3)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_grid_backend_refusals_match_reference():
    """A square-N non-grid graph is refused, and so is a side the ranks do
    not divide, with the reference's messages."""
    jf = JFilter.from_multipliers([jmult.heat(0.5)], 8, graph=jgraph.ring_graph(256), lmax=4.0)
    tf = GraphFilter.from_multipliers([tmult.heat(0.5)], 8,
                                      graph=tgraph.ring_graph(256, device="cpu"), lmax=4.0)
    with pytest.raises(ValueError, match="4-neighbour") as want:
        jf.apply(jnp.ones((256,)), backend="grid")
    with pytest.raises(ValueError) as got:
        tf.apply(torch.ones(256), backend="grid")
    assert str(got.value) == str(want.value)

    class ThreeRanks:  # the reference builds its mesh from real devices
        shape = {"grid": 3}

    jg = JFilter.from_multipliers([jmult.heat(0.5)], 8, graph=jgraph.grid_graph(16), lmax=8.0)
    tg = GraphFilter.from_multipliers([tmult.heat(0.5)], 8,
                                      graph=tgraph.grid_graph(16, device="cpu"), lmax=8.0)
    with pytest.raises(ValueError) as want:
        jget_backend("grid").prepare(jg, mesh=ThreeRanks())
    with pytest.raises(ValueError) as got:
        tg.apply(torch.ones(256), backend="grid", n_parts=3)
    assert str(got.value) == str(want.value) == "side=16 not divisible by n_parts=3"


def test_ring_and_torus_graphs_match_reference():
    for n in (5, 256):
        assert np.array_equal(tgraph.ring_graph(n, device="cpu").adjacency.numpy(),
                              np.asarray(jgraph.ring_graph(n).adjacency))
    for rows, cols in ((3, 4), (2, 5), (1, 4)):
        assert np.array_equal(tgraph.torus_graph(rows, cols, device="cpu").adjacency.numpy(),
                              np.asarray(jgraph.torus_graph(rows, cols).adjacency))


# ---- capabilities and the solver layer -----------------------------------


def test_capabilities_and_multi_shift_refusal(sensor_setting):
    _, tf, f = sensor_setting
    for name in ("halo", "allgather", "grid"):
        caps = backend_capabilities(name)
        assert not caps.traceable and not caps.sparse_input
        # halo runs joint filters (per-shift plans), as the reference's does
        assert caps.multi_shift == (name == "halo")
    # two copies of one shift commute: the joint filter is a polynomial in L
    joint = GraphFilter.from_shifts([tf.graph, tf.graph], np.ones((1, 3, 3)) / 4,
                                    lmaxes=[tf.lmax, tf.lmax])
    ft = torch.as_tensor(f)
    _close(joint.apply(ft, backend="halo", n_parts=4), joint.apply(ft, backend="dense").numpy(),
           1e-5)
    for name in ("allgather", "grid"):
        with pytest.raises(ValueError, match=rf"'{name}'.*'multi_shift'"):
            joint.apply(ft, backend=name, n_parts=4)
    assert get_backend("halo").state_key == get_backend("allgather").state_key


def test_lasso_words_per_iteration_match_reference():
    """``benchmarks/run.py::tab_solvers`` at P = 8: one length-1 forward
    and one length-eta adjoint per iteration."""
    with jax.threefry_partitionable(False):
        kg, _ = jax.random.split(jax.random.PRNGKey(42))
    g = _bench_graph(kg, n=500)
    lmax = float(g.lmax_bound())
    jf = JFilter.from_multipliers(jmult.sgwt_filter_bank(lmax, n_scales=3), 20, graph=g,
                                  lmax=lmax)
    plan = jdist.build_partition_plan(g.adjacency, g.coords, 8)  # the live reference
    want = {"halo": 20 * plan.halo_words * (1 + jf.eta),
            "allgather": 20 * plan.n_local * 8 * 7 * (1 + jf.eta)}
    tg = interop.sensor_graph_from_numpy(np.asarray(g.adjacency), np.asarray(g.coords), "cpu")
    problem = ts.LassoProblem(filt=interop.filter_from_numpy(jf.coeffs, lmax, tg),
                              y=torch.zeros(500), mu=2.0)
    got = {be: problem.messages_per_iteration(be, n_parts=8) for be in want}
    assert got == want
    assert got == {"halo": 29200, "allgather": 352800}  # BENCH_pr10.json, second


def test_ista_on_halo_matches_reference_dense():
    g = jgraph.connected_sensor_graph(jax.random.PRNGKey(1), n=96, sigma=0.17, kappa=0.18)
    lmax = float(g.lmax_bound())
    f0 = g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2 - 1.0
    y = np.asarray(f0 + 0.5 * jax.random.normal(jax.random.PRNGKey(2), f0.shape))
    jf = JFilter.from_multipliers(jmult.sgwt_filter_bank(lmax, n_scales=3), 16, graph=g,
                                  lmax=lmax)
    from repro import solvers as js

    want = js.ista(js.LassoProblem(filt=jf, y=jnp.asarray(y), mu=2.0), n_iters=10)
    tg = interop.sensor_graph_from_numpy(np.asarray(g.adjacency), np.asarray(g.coords), "cpu")
    problem = ts.LassoProblem(filt=interop.filter_from_numpy(jf.coeffs, lmax, tg),
                              y=torch.as_tensor(y), mu=2.0)
    got = ts.ista(problem, n_iters=10, backend="halo", n_parts=8)
    _close(got.x, want.x, 1e-5)
    _close(got.aux, want.aux, 1e-5)
    np.testing.assert_allclose(got.history, want.history, rtol=1e-4, atol=1e-4)
    assert got.messages_per_iteration == problem.messages_per_iteration("halo", n_parts=8) > 0


# ---- the example modules -------------------------------------------------


def test_distributed_denoising_runs_on_cpu():
    from repro_torch import distributed_denoising

    res = distributed_denoising.main(device="cpu")
    assert max(res["errs"].values()) < 1e-4 and res["gram_err"] < 1e-3
    assert res["words"]["halo"] <= res["radio_words"] < res["words"]["allgather"] * 2
    assert res["denoised_mse"] < 0.05 < res["noisy_mse"]


def test_distributed_wavelet_ista_runs_on_cpu():
    from repro_torch import distributed_wavelet_ista

    res = distributed_wavelet_ista.main(device="cpu")
    assert res["deviation"] < 1e-3 and res["sparsity"] > 0.2
    assert 0 < res["words_per_iteration"] <= res["radio_words"]
    assert res["objective_fista_half"] <= 1.001 * res["objective_ista"]


# ---- a real process group ------------------------------------------------

_GLOO = r"""
import sys
import torch.multiprocessing as mp


def rank_main(rank, world, store):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    from repro_torch.core import graph as tg, multipliers as tm
    from repro_torch.core.collectives import GroupMesh, StackedMesh
    from repro_torch.filters import GraphFilter
    from repro_torch.filters import shift_matvec_counts as joint_counts

    gen = torch.Generator().manual_seed(3)
    g = tg.connected_sensor_graph(gen, n=120, sigma=0.15, kappa=0.16, device="cpu")
    filt = GraphFilter.from_multipliers([tm.tikhonov(1.0, 1), tm.heat(0.5)], 12, graph=g)
    f = torch.randn(120, 3, generator=gen)
    gm, sm = GroupMesh(device="cpu"), StackedMesh(world, "cpu")
    worst = 0.0

    def compare(call, kind):
        nonlocal worst
        gm.reset_counts()
        sm.reset_counts()
        got, want = call(gm), call(sm)
        worst = max(worst, float((got - want).abs().max()))
        assert gm.calls[kind] == sm.calls[kind] > 0, (kind, dict(gm.calls), dict(sm.calls))
        moved = torch.tensor([gm.elements[kind]])
        dist.all_reduce(moved)
        assert int(moved) == sm.elements[kind], (kind, int(moved), dict(sm.elements))

    # None: each mesh's own default (overlapped on the group, serial stacked)
    for overlap in (True, False, None):
        compare(lambda m: filt.apply(f, backend="halo", mesh=m, overlap=overlap), "all_to_all")
    compare(lambda m: filt.apply(f, backend="allgather", mesh=m), "all_gather")
    a = filt.apply(f, backend="dense")
    compare(lambda m: filt.adjoint(a, backend="halo", mesh=m), "all_to_all")
    gg = tg.grid_graph(16, device="cpu")
    gf = GraphFilter.from_multipliers([tm.heat(0.5)], 10, graph=gg, lmax=8.0)
    x = torch.randn(256, 2, generator=gen)
    compare(lambda m: gf.apply(x, backend="grid", mesh=m), "shift")
    ga = gf.apply(x, backend="dense")
    compare(lambda m: gf.adjoint(ga, backend="grid", mesh=m), "shift")
    # two shifts (a time-vertex product): per-shift halo plans on one layout
    from repro_torch.core import chebyshev as tc

    gs = tg.connected_sensor_graph(gen, n=20, sigma=0.3, kappa=0.35, device="cpu")
    t = 4
    path = torch.diag(torch.ones(t - 1), 1) + torch.diag(torch.ones(t - 1), -1)
    xy = gs.coords.repeat_interleave(t, 0)
    tt = (torch.arange(t) / t).repeat(20)[:, None]
    coords = torch.cat([xy, tt], dim=1)
    shifts = [tg.SensorGraph(torch.kron(gs.adjacency, torch.eye(t)), coords),
              tg.SensorGraph(torch.kron(torch.eye(20), path), coords)]
    lms = [float(s.lmax_bound()) for s in shifts]
    joint = GraphFilter.from_shifts(shifts, tc.separable_joint_coefficients([
        tc.cheb_coefficients([tm.heat(0.6), tm.tikhonov(1.0, 1)], 6, lms[0]),
        tc.cheb_coefficients([tm.heat(1.2)], 3, lms[1])]), lmaxes=lms)
    xj = torch.randn(80, 2, generator=gen)
    compare(lambda m: joint.apply(xj, backend="halo", mesh=m), "all_to_all")
    assert gm.calls["all_to_all"] == sum(joint_counts(joint.orders))
    aj = joint.apply(xj, backend="dense")
    compare(lambda m: joint.adjoint(aj, backend="halo", mesh=m), "all_to_all")
    assert worst < 1e-6, worst
    print(f"rank {rank} max|group - stacked| {worst:.2e}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(4, sys.argv[1]), nprocs=4, join=True)
    print("OK")
"""


def run_gloo_ranks(script_text: str, tmp_path) -> str:
    """Run ``script_text`` (which spawns its ranks with
    ``torch.multiprocessing.spawn`` and takes the file-store path as its
    argument) in a subprocess; returns its standard output. The ranks
    rendezvous through a file store in ``tmp_path``: no port."""
    script = tmp_path / "gloo_ranks.py"
    script.write_text(script_text)
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "store")], capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=tmp_path,
    )
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def test_group_mesh_on_gloo_matches_stacked_mesh(tmp_path):
    """4 gloo ranks: ``GroupMesh`` against ``StackedMesh(4)`` within 1e-6
    for halo (both schedules), allgather, grid, the halo adjoint and a
    two-shift joint filter's halo apply and adjoint, with
    equal exchange counts and, summed over ranks, equal elements moved."""
    out = run_gloo_ranks(_GLOO, tmp_path)
    assert out.count("max|group - stacked|") == 4 and "OK" in out
