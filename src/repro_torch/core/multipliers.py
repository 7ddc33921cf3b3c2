"""Multiplier zoo: the spectral kernels used by the paper's applications.

Mirrors ``repro/core/multipliers.py``: a numpy copy, held to the
reference bit for bit.

* ``heat(t)``          — Sec. V-A distributed smoothing, ``g = exp(-t x)``.
* ``tikhonov(tau, r)`` — Sec. V-B Prop. 1 regularization/denoising filter
                         ``g = tau / (tau + 2 x^r)`` (graph Bessel analog).
* ``sgwt_*``           — Sec. V-C spectral graph wavelet transform kernels
                         (Hammond, Vandergheynst, Gribonval 2011, ref. [20]):
                         one low-pass scaling kernel ``h`` plus J band-pass
                         wavelet kernels ``g(t_j x)`` — precisely a union of
                         graph Fourier multipliers with eta = J + 1.

All multipliers are plain numpy-vectorized callables ``[0, lmax] -> R`` so
they can be fed to ``cheb_coefficients`` (quadrature runs on host float64).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np

__all__ = [
    "heat",
    "tikhonov",
    "ideal_lowpass",
    "sgwt_wavelet_kernel",
    "sgwt_scaling_kernel",
    "sgwt_scales",
    "sgwt_filter_bank",
]

Multiplier = Callable[[np.ndarray], np.ndarray]


def heat(t: float) -> Multiplier:
    """Heat kernel ``g(x) = exp(-t x)`` — low-pass smoothing (Sec. V-A)."""

    def g(x):
        return np.exp(-t * np.asarray(x, dtype=np.float64))

    return g


def tikhonov(tau: float = 1.0, r: int = 1) -> Multiplier:
    """Proposition 1 filter ``g(x) = tau / (tau + 2 x^r)``.

    The closed-form solution of
    ``argmin_f tau/2 ||f - y||^2 + f^T L^r f`` is ``R y`` with this
    multiplier; for r=1 it is the graph analog of a first-order Bessel
    filter (paper footnote 1).
    """

    def g(x):
        x = np.asarray(x, dtype=np.float64)
        return tau / (tau + 2.0 * np.power(np.maximum(x, 0.0), r))

    return g


def ideal_lowpass(cutoff: float) -> Multiplier:
    """Indicator multiplier 1{x <= cutoff} — the Sec. III-A projection
    example (discontinuous: a stress test for the truncated expansion)."""

    def g(x):
        return (np.asarray(x, dtype=np.float64) <= cutoff).astype(np.float64)

    return g


def sgwt_wavelet_kernel(
    x1: float = 1.0, x2: float = 2.0, alpha: float = 2.0, beta: float = 2.0
) -> Multiplier:
    """Hammond et al. band-pass wavelet generating kernel ``g``.

    Monic power-law rise ``x^alpha`` below x1, cubic-spline plateau on
    [x1, x2], power-law decay ``x^-beta`` above x2 — C^1 by construction
    with s(x) = -5 + 11x - 6x^2 + x^3 for the default (1, 2, 2, 2) setting.
    """

    def g(x):
        x = np.asarray(x, dtype=np.float64)
        lo = (x / x1) ** alpha
        mid = -5.0 + 11.0 * x - 6.0 * x**2 + x**3
        hi = (x2 / np.maximum(x, 1e-30)) ** beta
        return np.where(x < x1, lo, np.where(x <= x2, mid, hi))

    return g


def sgwt_scaling_kernel(lmax: float, K: float = 20.0, gamma: float | None = None) -> Multiplier:
    """Hammond et al. low-pass scaling kernel
    ``h(x) = gamma * exp(-(x / (0.6 lmin))^4)`` with ``lmin = lmax / K``.

    gamma defaults to the wavelet kernel's maximum so the scaling band has
    comparable magnitude to the wavelet bands.
    """
    lmin = lmax / K
    if gamma is None:
        g = sgwt_wavelet_kernel()
        gamma = float(np.max(g(np.linspace(0.0, lmax, 4096))))

    def h(x):
        x = np.asarray(x, dtype=np.float64)
        return gamma * np.exp(-((x / (0.6 * lmin)) ** 4))

    return h


def sgwt_scales(lmax: float, n_scales: int, K: float = 20.0,
                x1: float = 1.0, x2: float = 2.0) -> np.ndarray:
    """Log-spaced wavelet scales t_j covering [lmin, lmax] (ref. [20])."""
    lmin = lmax / K
    t_min, t_max = x1 / lmax, x2 / lmin
    return np.exp(np.linspace(np.log(t_max), np.log(t_min), n_scales))


def sgwt_filter_bank(
    lmax: float, n_scales: int = 4, K: float = 20.0
) -> List[Multiplier]:
    """The full SGWT union: ``[h, g(t_1 .), ..., g(t_J .)]`` (eta = J + 1).

    This is exactly the operator W of paper Sec. V-C — "precisely of the
    form of Phi in (6)".
    """
    g = sgwt_wavelet_kernel()
    scales = sgwt_scales(lmax, n_scales, K)
    bank: List[Multiplier] = [sgwt_scaling_kernel(lmax, K)]
    for t in scales:
        bank.append(lambda x, t=t: g(t * np.asarray(x, dtype=np.float64)))
    return bank
