"""The SGWT bank, its Chebyshev coefficients and the shifted recurrence.

* The spectral graph wavelet kernels of Hammond, Vandergheynst and
  Gribonval (2011), frozen here: a low-pass scaling kernel
  ``h(x) = gamma exp(-(x / (0.6 lmin))^4)`` with ``lmin = lmax / K`` and
  ``gamma`` the wavelet kernel's maximum on [0, lmax], and J band-pass
  kernels ``g(t_j x)``, ``g`` rising as ``x^2`` below 1, the cubic
  ``-5 + 11x - 6x^2 + x^3`` on [1, 2] and ``(2/x)^2`` above, with J scales
  log-spaced from ``2 / lmin`` down to ``1 / lmax``.
* Paper eq. 8: ``c_{j,k} = (2/pi) int_0^pi cos(k th) g_j(a (cos th + 1)) dth``,
  ``a = lmax / 2``, by midpoint quadrature at ``max(M + 1, 64) * 4`` nodes.
* Paper eq. 9-11: ``T_0 f = f``, ``T_1 f = (L - aI) f / a``,
  ``T_k f = (2/a)(L - aI) T_{k-1} f - T_{k-2} f``, and
  ``Phi_j f = c_{j,0}/2 f + sum_k c_{j,k} T_k f``; the adjoint (eq. 13) is
  ``sum_j Phi_j a_j`` (L is symmetric).

The recurrence runs in float64, or in float32 when ``matvec`` returns
float32 (the control).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "sgwt_bank",
    "cheb_coefficients",
    "cheb_eval",
    "operator_norm_bound",
    "apply",
    "adjoint",
]


def _wavelet(x):
    x = np.asarray(x, dtype=np.float64)
    lo = x**2
    mid = -5.0 + 11.0 * x - 6.0 * x**2 + x**3
    hi = (2.0 / np.maximum(x, 1e-30)) ** 2
    return np.where(x < 1.0, lo, np.where(x <= 2.0, mid, hi))


def sgwt_bank(lmax: float, n_scales: int, k: float = 20.0) -> list:
    """``[h, g(t_1 .), ..., g(t_J .)]``: eta = J + 1 kernels on [0, lmax]."""
    lmin = lmax / k
    gamma = float(np.max(_wavelet(np.linspace(0.0, lmax, 4096))))
    scales = np.exp(np.linspace(np.log(2.0 / lmin), np.log(1.0 / lmax), n_scales))

    def scaling(x):
        x = np.asarray(x, dtype=np.float64)
        return gamma * np.exp(-((x / (0.6 * lmin)) ** 4))

    return [scaling] + [lambda x, t=t: _wavelet(t * np.asarray(x, dtype=np.float64))
                        for t in scales]


def cheb_coefficients(kernels, order: int, lmax: float) -> np.ndarray:
    """(eta, M + 1) float64 coefficients, eq. 8."""
    p = max(order + 1, 64) * 4
    theta = np.pi * (np.arange(p) + 0.5) / p
    x = lmax / 2.0 * (np.cos(theta) + 1.0)
    basis = np.cos(np.outer(np.arange(order + 1), theta))
    return np.stack([(2.0 / p) * (basis @ np.asarray(g(x), dtype=np.float64)) for g in kernels])


def cheb_eval(coeffs: np.ndarray, x: np.ndarray, lmax: float) -> np.ndarray:
    """The truncated series at points ``x``: (eta, len(x))."""
    y = (np.asarray(x, dtype=np.float64) - lmax / 2.0) / (lmax / 2.0)
    t_prev, t_cur = np.ones_like(y), y
    out = 0.5 * coeffs[:, :1] * t_prev + coeffs[:, 1:2] * t_cur
    for k in range(2, coeffs.shape[1]):
        t_prev, t_cur = t_cur, 2.0 * y * t_cur - t_prev
        out = out + coeffs[:, k:k + 1] * t_cur
    return out


def operator_norm_bound(coeffs: np.ndarray, lmax: float) -> float:
    """``max_x sum_j p_j(x)^2`` on 8192 points of [0, lmax]: the squared
    frame bound whose inverse is the lasso's gradient step."""
    vals = cheb_eval(coeffs, np.linspace(0.0, lmax, 8192), lmax)
    return float(np.max(np.sum(vals**2, axis=0)))


def _krylov(matvec, v: torch.Tensor, lmax: float, n_terms: int):
    """Yield ``T_k v`` for k = 0 .. n_terms - 1 (v is (N, K))."""
    a = lmax / 2.0
    t_prev = v
    yield t_prev
    t_cur = (matvec(v) - a * v) / a
    yield t_cur
    for _ in range(2, n_terms):
        t_prev, t_cur = t_cur, (2.0 / a) * (matvec(t_cur) - a * t_cur) - t_prev
        yield t_cur


def apply(matvec, f: torch.Tensor, coeffs: np.ndarray, lmax: float) -> torch.Tensor:
    """``Phi f`` for (N, F) ``f``: (eta, N, F)."""
    c = torch.as_tensor(coeffs, device=f.device, dtype=f.dtype)
    half = c.clone()
    half[:, 0] *= 0.5
    out = None
    for k, t in enumerate(_krylov(matvec, f, lmax, c.shape[1])):
        term = half[:, k, None, None] * t[None]
        out = term if out is None else out + term
    return out


def adjoint(matvec, a: torch.Tensor, coeffs: np.ndarray, lmax: float) -> torch.Tensor:
    """``Phi* a = sum_j Phi_j a_j`` for (eta, N, F) ``a``: (N, F)."""
    eta, n, f = a.shape
    c = torch.as_tensor(coeffs, device=a.device, dtype=a.dtype)
    half = c.clone()
    half[:, 0] *= 0.5
    v = a.permute(1, 2, 0).reshape(n, f * eta)
    out = None
    for k, t in enumerate(_krylov(matvec, v, lmax, c.shape[1])):
        term = t.reshape(n, f, eta) @ half[:, k]
        out = term if out is None else out + term
    return out
