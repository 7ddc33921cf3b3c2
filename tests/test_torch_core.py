"""Port parity for ``repro_torch.core``: multipliers, graph utilities,
Chebyshev expansion/recurrences and the exact oracles, held against the
JAX package on identical numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chebyshev as jcheb
from repro.core import graph as jgraph
from repro.core import multipliers as jmult
from repro.core import operators as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import chebyshev as tcheb
from repro_torch.core import graph as tgraph
from repro_torch.core import multipliers as tmult
from repro_torch.core import operators as tops
from repro_torch.kernels import ref as tref

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """Make one multi-threaded ``torch.exp`` call before the tests.

    On torch 2.13.0+cpu the first ``torch.exp`` of a process that spans
    several intra-op threads (the CPU kernel splits work into 2048-element
    grains) came back with errors up to 1e-4 in the grains of one or two
    worker threads in about one module run in three; the next call on the
    same input was exact to 3e-8. A call beforehand removed it (0 of 20
    module runs against 6 of 16). The fault is in the runtime's first use,
    not in the code under test, which stays held to 1e-6 below."""
    torch.exp(torch.zeros(1 << 16))


@pytest.fixture(scope="module")
def ref_graph():
    """The reference's connected sensor graph on coordinates drawn with
    numpy: float32 whatever ``jax_enable_x64`` says (other modules in the
    same process toggle it), and owned by numpy, not views of JAX buffers."""
    rng = np.random.RandomState(0)
    while True:
        coords = rng.uniform(size=(96, 2)).astype(np.float32)
        adj = np.array(jgraph.gaussian_kernel_weights(jnp.asarray(coords, jnp.float32), 0.17, 0.18))
        if jgraph.is_connected(adj):
            break
    g = jgraph.SensorGraph(jnp.asarray(adj), jnp.asarray(coords))
    return g, adj, coords


def _banks(lmax):
    return {
        "heat": ([jmult.heat(0.7)], [tmult.heat(0.7)]),
        "tikhonov": ([jmult.tikhonov(1.0, 2)], [tmult.tikhonov(1.0, 2)]),
        "lowpass": ([jmult.ideal_lowpass(2.0)], [tmult.ideal_lowpass(2.0)]),
        "sgwt": (jmult.sgwt_filter_bank(lmax, 4), tmult.sgwt_filter_bank(lmax, 4)),
    }


@pytest.mark.parametrize("bank", ["heat", "tikhonov", "lowpass", "sgwt"])
def test_multipliers_and_coefficients_bit_identical(bank):
    lmax = 11.3
    jb, tb = _banks(lmax)[bank]
    x = np.linspace(0.0, lmax, 513)
    for gj, gt in zip(jb, tb):
        assert np.asarray(gj(x)).tobytes() == np.asarray(gt(x)).tobytes()
    cj = jcheb.cheb_coefficients(jb, 20, lmax)
    ct = tcheb.cheb_coefficients(tb, 20, lmax)
    assert cj.dtype == ct.dtype == np.float64
    assert cj.tobytes() == ct.tobytes()
    assert jcheb.gram_coefficients(cj).tobytes() == tcheb.gram_coefficients(ct).tobytes()
    assert jcheb.cheb_eval(cj, x, lmax).tobytes() == tcheb.cheb_eval(ct, x, lmax).tobytes()


def test_sgwt_scales_bit_identical():
    a = jmult.sgwt_scales(17.0, 5)
    b = tmult.sgwt_scales(17.0, 5)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n_parts", [1, 7, 12, 64])
def test_spatial_partition_order_bit_identical(ref_graph, n_parts):
    _, _, coords = ref_graph
    a = jgraph.spatial_partition_order(coords, n_parts)
    b = tgraph.spatial_partition_order(coords, n_parts)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("k", [0, 1, 3, 10])
def test_khop_neighborhood_bit_identical(ref_graph, k):
    _, adj, _ = ref_graph
    support = np.zeros(adj.shape[0], dtype=bool)
    support[[3, 50]] = True
    assert np.array_equal(
        jgraph.khop_neighborhood(adj, support, k), tgraph.khop_neighborhood(adj, support, k)
    )
    assert np.array_equal(
        jgraph.khop_neighborhood(adj, [7], k), tgraph.khop_neighborhood(adj, [7], k)
    )


def test_is_connected_matches(ref_graph):
    _, adj, _ = ref_graph
    assert tgraph.is_connected(adj) == jgraph.is_connected(adj) is True
    cut = adj.copy()
    cut[5, :] = cut[:, 5] = 0.0
    assert tgraph.is_connected(cut) == jgraph.is_connected(cut) is False
    assert tgraph.is_connected(cut, ignore_isolated=True) == jgraph.is_connected(
        cut, ignore_isolated=True
    )


@pytest.mark.parametrize("block", [8, 16])
def test_bsr_from_dense_bit_identical(ref_graph, block):
    _, adj, coords = ref_graph
    lap = np.asarray(jgraph.laplacian(jnp.asarray(adj)), np.float64)
    order = jgraph.spatial_partition_order(coords, max(96 // block, 1))
    lap = lap[np.ix_(order, order)]
    want = jref.bsr_from_dense(lap, block)
    got = tref.bsr_from_dense(torch.as_tensor(lap), block)
    assert got.blocks.dtype == torch.float32 and got.cols.dtype == torch.int32
    assert np.asarray(want.blocks).tobytes() == got.blocks.numpy().tobytes()
    assert np.asarray(want.cols).tobytes() == got.cols.numpy().tobytes()
    assert got.nnz_blocks == want.nnz_blocks
    dense = tref.bsr_to_dense(got).numpy()
    np.testing.assert_array_equal(dense, np.asarray(jref.bsr_to_dense(want)))


def _weights_f64(coords, sigma, kappa):
    c = coords.astype(np.float64)
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    w = np.where(d2 <= kappa**2, np.exp(-d2 / (2 * sigma**2)), 0.0)
    np.fill_diagonal(w, 0.0)
    return w


def test_graph_functions_match_reference(ref_graph):
    # Both sides compute in float32 on their own copies of the inputs:
    # ``np.array`` copies each JAX result, so no torch tensor shares a JAX
    # buffer. Each side is also held to a float64 oracle, so a failure
    # names the side that strays: w is in [0, 1] and a float32 exp and
    # square of differences in [0, 1] stay within a few ulps (1e-6).
    coords = ref_graph[2].copy()
    sigma, kappa = 0.17, 0.18
    w64 = _weights_f64(coords, sigma, kappa)
    wj = np.array(jgraph.gaussian_kernel_weights(jnp.asarray(coords, jnp.float32), sigma, kappa))
    wt = tgraph.gaussian_kernel_weights(torch.tensor(coords, dtype=torch.float32), sigma, kappa)
    assert wj.dtype == np.float32 and wt.dtype == torch.float32
    np.testing.assert_allclose(wj, w64, atol=1e-6, rtol=0, err_msg="reference vs float64")
    np.testing.assert_allclose(wt.numpy(), w64, atol=1e-6, rtol=0, err_msg="port vs float64")
    np.testing.assert_allclose(wt.numpy(), wj, atol=1e-6, rtol=0)
    assert np.array_equal(wt.numpy() > 0, wj > 0)
    lj = np.array(jgraph.laplacian(jnp.asarray(wj)))
    lt = tgraph.laplacian(torch.tensor(wj))
    # Degrees are f32 sums taken in another order: 1e-6 relative.
    np.testing.assert_allclose(lt.numpy(), lj, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tgraph.degree_vector(torch.tensor(wj)).numpy(),
        np.array(jgraph.degree_vector(jnp.asarray(wj))), atol=1e-6, rtol=1e-6,
    )
    mj = float(jgraph.lmax_upper_bound(jnp.asarray(wj)))
    mt = float(tgraph.lmax_upper_bound(torch.tensor(wj)))
    assert abs(mj - mt) <= 1e-6 * max(1.0, abs(mj))


def test_grid_graph_matches_reference():
    gj = jgraph.grid_graph(5)
    gt = tgraph.grid_graph(5, device=CPU)
    assert np.array_equal(np.asarray(gj.adjacency), gt.adjacency.numpy())
    np.testing.assert_allclose(np.asarray(gj.coords), gt.coords.numpy(), atol=1e-7)
    assert gt.n_edges == gj.n_edges == 40


def test_generator_statistics_match_reference():
    """The port draws its own coordinates: hold it to the reference's
    mean degree and edge count over the same number of draws, not bits."""
    n, draws = 300, 6
    ref_edges = [
        jgraph.random_sensor_graph(jax.random.PRNGKey(s), n, 0.1, 0.12).n_edges
        for s in range(draws)
    ]
    gen = torch.Generator().manual_seed(0)
    port_edges = [
        tgraph.random_sensor_graph(gen, n, 0.1, 0.12, device=CPU).n_edges for _ in range(draws)
    ]
    # |E| is ~1750 here with a draw-to-draw spread of a few tens, so the
    # two means (and mean degrees) agree within 10 %.
    rj, rt = np.mean(ref_edges), np.mean(port_edges)
    assert abs(rj - rt) < 0.1 * rj, (ref_edges, port_edges)
    assert abs(2 * rt / n - 2 * rj / n) < 0.1 * (2 * rj / n)
    g = tgraph.connected_sensor_graph(torch.Generator().manual_seed(1), n=120,
                                      sigma=0.17, kappa=0.18, device=CPU)
    assert tgraph.is_connected(g.adjacency.numpy())
    assert g.adjacency.dtype == torch.float32 and g.coords.shape == (120, 2)


def _dense_mv(lap):
    return lambda v: lap @ v


@pytest.mark.parametrize("shape", [(96,), (96, 3)])
def test_recurrences_match_reference(ref_graph, shape):
    g, adj, _ = ref_graph
    lmax = float(g.lmax_bound())
    coeffs = jcheb.cheb_coefficients([jmult.heat(0.6), jmult.tikhonov(1.0, 1)], 12, lmax)
    f = np.random.RandomState(1).randn(*shape).astype(np.float32)
    lap_j = g.laplacian()
    lap_t = interop.sensor_graph_from_numpy(adj, device=CPU).laplacian()
    want = np.asarray(jcheb.cheb_apply(_dense_mv(lap_j), jnp.asarray(f), coeffs, lmax))
    got = tcheb.cheb_apply(_dense_mv(lap_t), torch.as_tensor(f), coeffs, lmax)
    assert got.dtype == torch.float32  # float64 coeffs must not promote
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tcheb.cheb_apply_dense(lap_t, torch.as_tensor(f), coeffs, lmax).numpy(), want,
        atol=1e-5, rtol=1e-5,
    )
    kj_out, kj = jcheb.cheb_apply_krylov(_dense_mv(lap_j), jnp.asarray(f), coeffs, lmax)
    kt_out, kt = tcheb.cheb_apply_krylov(_dense_mv(lap_t), torch.as_tensor(f), coeffs, lmax)
    assert kt.shape == (13,) + shape
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(kt_out.numpy(), np.asarray(kj_out), atol=1e-5, rtol=1e-5)
    a = np.random.RandomState(2).randn(2, *shape).astype(np.float32)
    tdot_j = lambda v: jnp.tensordot(lap_j, v, axes=1)  # noqa: E731
    tdot_t = lambda v: torch.tensordot(lap_t, v, dims=1)  # noqa: E731
    np.testing.assert_allclose(
        tcheb.cheb_adjoint_apply(tdot_t, torch.as_tensor(a), coeffs, lmax).numpy(),
        np.asarray(jcheb.cheb_adjoint_apply(tdot_j, jnp.asarray(a), coeffs, lmax)),
        atol=1e-5, rtol=1e-5,
    )


def test_recurrence_keeps_float32_under_float64_coefficients():
    lap = torch.eye(4) * 2.0
    c = np.array([[1.0, 0.5, 0.25]], dtype=np.float64)
    out = tcheb.cheb_apply(lambda v: lap @ v, torch.ones(4), c, 4.0)
    assert out.dtype == torch.float32


def test_exact_oracles_match_reference(ref_graph):
    g, adj, _ = ref_graph
    lap = np.asarray(g.laplacian(), np.float64)
    bank_j = [jmult.heat(0.5), jmult.tikhonov(1.0, 1)]
    bank_t = [tmult.heat(0.5), tmult.tikhonov(1.0, 1)]
    f = np.random.RandomState(3).randn(96)
    np.testing.assert_array_equal(
        tops.exact_multiplier_matrix(lap, bank_t), jops.exact_multiplier_matrix(lap, bank_j)
    )
    np.testing.assert_array_equal(
        tops.exact_union_apply(torch.as_tensor(lap), bank_t, torch.as_tensor(f)),
        jops.exact_union_apply(lap, bank_j, f),
    )
