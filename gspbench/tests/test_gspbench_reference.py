"""The plain reference against float64 NumPy at small N: the eq. 1 graph,
the frozen SGWT bank, the eq. 9/11 apply and its adjoint (against the
eigendecomposition), FISTA (against dense matrices), and the control's
TF32 rounding."""

import numpy as np
import pytest
import torch

from gspbench.reference import cheb, fista, graph

N, F, ORDER, SCALES = 96, 3, 20, 4
SIGMA, KAPPA = 0.16, 0.2


def _coords(seed=0):
    return torch.rand((N, 2), generator=torch.Generator().manual_seed(seed))


def _dense_laplacian(coords):
    c = coords.numpy().astype(np.float32)
    d2_32 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    c64 = c.astype(np.float64)
    w = np.exp(-((c64[:, None, :] - c64[None, :, :]) ** 2).sum(-1) / (2 * SIGMA**2))
    w = np.where(d2_32 <= np.float32(KAPPA**2), w, 0.0)
    np.fill_diagonal(w, 0.0)
    return np.diag(w.sum(1)) - w, w


def test_laplacian_matches_dense_numpy():
    coords = _coords()
    lap = graph.sensor_laplacian(coords, SIGMA, KAPPA, rows_per_block=17)
    dense, w = _dense_laplacian(coords)
    assert lap.n_edges == int((w > 0).sum()) // 2
    assert lap.nnz == 2 * lap.n_edges + N
    v = np.random.default_rng(1).normal(size=(N, F))
    got = lap.operator("float64")(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, dense @ v, rtol=0, atol=1e-12)
    deg = w.sum(1)
    want_lmax = max(deg[i] + deg[j] for i, j in zip(*np.nonzero(w)))
    assert lap.lmax_bound() == pytest.approx(want_lmax, rel=1e-14)


def test_frozen_sgwt_bank_matches_the_program():
    from repro_torch.core import chebyshev, multipliers

    lmax = 7.3
    x = np.linspace(0.0, lmax, 1001)
    ours = cheb.sgwt_bank(lmax, SCALES)
    theirs = multipliers.sgwt_filter_bank(lmax, SCALES, 20.0)
    for g, h in zip(ours, theirs, strict=True):
        np.testing.assert_allclose(g(x), h(x), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(cheb.cheb_coefficients(ours, ORDER, lmax),
                               chebyshev.cheb_coefficients(theirs, ORDER, lmax), rtol=0, atol=1e-13)


def _spectral(dense, coeffs, lmax):
    lam, u = np.linalg.eigh(dense)
    p = cheb.cheb_eval(coeffs, lam, lmax)  # (eta, N)
    return np.stack([u @ np.diag(pj) @ u.T for pj in p])  # (eta, N, N)


def test_apply_and_adjoint_match_the_eigendecomposition():
    coords = _coords(2)
    lap = graph.sensor_laplacian(coords, SIGMA, KAPPA)
    dense, _ = _dense_laplacian(coords)
    lmax = lap.lmax_bound()
    coeffs = cheb.cheb_coefficients(cheb.sgwt_bank(lmax, SCALES), ORDER, lmax)
    phi = _spectral(dense, coeffs, lmax)
    rng = np.random.default_rng(3)
    f = rng.normal(size=(N, F))
    a = rng.normal(size=(coeffs.shape[0], N, F))
    op = lap.operator("float64")
    got = cheb.apply(op, torch.as_tensor(f), coeffs, lmax).numpy()
    np.testing.assert_allclose(got, phi @ f, rtol=0, atol=1e-10)
    back = cheb.adjoint(op, torch.as_tensor(a), coeffs, lmax).numpy()
    np.testing.assert_allclose(back, np.einsum("jnm,jmf->nf", phi, a), rtol=0, atol=1e-10)


def test_fista_matches_dense_numpy():
    coords = _coords(4)
    lap = graph.sensor_laplacian(coords, SIGMA, KAPPA)
    dense, _ = _dense_laplacian(coords)
    lmax = lap.lmax_bound()
    coeffs = cheb.cheb_coefficients(cheb.sgwt_bank(lmax, SCALES), ORDER, lmax)
    phi = _spectral(dense, coeffs, lmax)
    y = np.random.default_rng(5).normal(size=(N, F))
    mu, iters = 0.3, 12
    tau = 1.0 / cheb.operator_norm_bound(coeffs, lmax)
    th = np.full((coeffs.shape[0], 1, 1), tau * mu)
    th[0] = 0.0
    a_prev = phi @ y
    z, t = a_prev, 1.0
    for _ in range(iters):
        v = z + tau * (phi @ (y - np.einsum("jnm,jmf->nf", phi, z)))
        a = np.sign(v) * np.maximum(np.abs(v) - th, 0.0)
        t_next = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        z = a + (t - 1) / t_next * (a - a_prev)
        a_prev, t = a, t_next
    got = fista.fista(lap.operator("float64"), torch.as_tensor(y), coeffs, lmax, mu, iters)
    np.testing.assert_allclose(got.numpy(), a_prev, rtol=0, atol=1e-9)
    assert np.count_nonzero(a_prev[1:]) < a_prev[1:].size  # the threshold bites


def test_round_tf32():
    ulp = 2.0**-10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, 1 + ulp / 4, -3.0 - ulp], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + 2 * ulp, 1.0, -3.0], dtype=torch.float32)
    got = graph.round_tf32(x)
    assert torch.equal(got, want)
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)


def test_control_operator_is_tf32_precise():
    coords = _coords(6)
    lap = graph.sensor_laplacian(coords, SIGMA, KAPPA)
    v = torch.randn((N, F), generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    exact = lap.operator("float64")(v)
    ctl = lap.operator("tf32")(v).to(torch.float64)
    rel = float((ctl - exact).abs().max() / exact.abs().max())
    assert 1e-5 < rel < 1e-2
