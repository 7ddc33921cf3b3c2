"""Paper Sec. V applications: smoothing, Tikhonov denoising, SGWT-lasso
denoising, Wiener denoising, inverse filtering and semi-supervised
classification.

Mirrors ``repro/apps/denoising.py``. Each routine builds a
:class:`GraphFilter` on the given graph and runs on any registered
backend; the signal stays on the graph's device (a numpy signal is placed
there). The solver-backed apps delegate to :mod:`repro_torch.solvers`.
Multiplier and ``psd`` callables take and return numpy, as in the
reference.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import multipliers as mult
from repro_torch.core.graph import SensorGraph
from repro_torch.filters import GraphFilter
from repro_torch.solvers import (
    GramProblem,
    LassoProblem,
    SolveResult,
    conjugate_gradient,
    solve,
    wiener,
)

__all__ = [
    "smooth_heat",
    "denoise_tikhonov",
    "wavelet_denoise_ista",
    "denoise_wiener",
    "inverse_filter",
    "ssl_classify",
]


def _as_filter(g: SensorGraph, bank, order: int, lmax: float):
    if not isinstance(g, SensorGraph):
        raise TypeError(
            f"expected a SensorGraph, got {type(g).__name__}; the legacy "
            "matvec-closure convention was removed — build a GraphFilter "
            "and use backend='matvec' directly"
        )
    return GraphFilter.from_multipliers(bank, order, graph=g, lmax=lmax)


def smooth_heat(
    graph: SensorGraph,
    y: torch.Tensor,
    lmax: float,
    t: float = 1.0,
    order: int = 20,
    *,
    backend: str | None = None,
    **opts,
) -> torch.Tensor:
    """Distributed smoothing (Sec. V-A): ``H~_t y`` with ``g = exp(-t x)``.
    ``y`` is (N,) or (N, F); ``backend`` defaults to ``dense``."""
    filt = _as_filter(graph, [mult.heat(t)], order, lmax)
    return filt.apply(y, backend=backend or "dense", **opts)[0]


def denoise_tikhonov(
    graph: SensorGraph,
    y: torch.Tensor,
    lmax: float,
    tau: float = 1.0,
    r: int = 1,
    order: int = 20,
    *,
    backend: str | None = None,
    **opts,
) -> torch.Tensor:
    """Distributed denoising (Sec. V-B, Prop. 1): ``R~ y`` with
    ``g(x) = tau / (tau + 2 x^r)``, the minimizer of
    ``tau/2 ||f - y||^2 + f^T L^r f``."""
    filt = _as_filter(graph, [mult.tikhonov(tau, r)], order, lmax)
    return filt.apply(y, backend=backend or "dense", **opts)[0]


def ssl_classify(
    graph: SensorGraph,
    labels: torch.Tensor,
    lmax: float,
    tau: float = 1.0,
    r: int = 1,
    order: int = 20,
    *,
    backend: str | None = None,
    **opts,
) -> torch.Tensor:
    """Distributed binary SSL (Sec. V-B end): labelled nodes carry +-1,
    unlabelled 0; every node outputs ``sign((R~ y)_n)``."""
    scores = denoise_tikhonov(graph, labels, lmax, tau, r, order, backend=backend, **opts)
    return torch.where(scores >= 0.0, 1.0, -1.0).to(scores.dtype)


def wavelet_denoise_ista(
    graph: SensorGraph,
    y,
    lmax: float,
    *,
    n_scales: int = 4,
    order: int = 24,
    mu=1.0,
    n_iters: int = 50,
    step: float | None = None,
    method: str = "ista",
    tol: float | None = None,
    backend: str | None = None,
    full_output: bool = False,
    **opts,
) -> tuple[torch.Tensor, torch.Tensor] | SolveResult:
    """SGWT-lasso denoising (Sec. V-C).

    Solves ``argmin_a 1/2 ||y - W~* a||^2 + ||a||_{1,mu}`` with ``W~`` the
    Chebyshev-approximated spectral graph wavelet transform (eta =
    n_scales + 1): ``method="ista"`` is the paper's eq. 21,
    ``method="fista"`` adds Nesterov momentum. ``tol`` stops on the
    relative objective change; ``full_output=True`` returns the
    :class:`SolveResult` instead of ``(denoised_signal, coefficients)``.
    """
    bank = mult.sgwt_filter_bank(lmax, n_scales=n_scales)
    filt = _as_filter(graph, bank, order, lmax)
    problem = LassoProblem(filt=filt, y=y, mu=mu, step=step)
    res = solve(problem, method=method, n_iters=n_iters, tol=tol,
                backend=backend or "dense", **opts)
    if full_output:
        return res
    return res.x, res.aux


def denoise_wiener(
    graph: SensorGraph,
    y,
    lmax: float,
    *,
    noise_power: float = 0.25,
    psd: Callable[[np.ndarray], np.ndarray] | None = None,
    order: int = 20,
    n_iters: int = 50,
    tol: float | None = 1e-6,
    backend: str | None = None,
    full_output: bool = False,
    **opts,
) -> torch.Tensor | SolveResult:
    """Iterative graph Wiener denoising (arXiv:2205.04019).

    Models the clean signal with spectral power density ``psd(lambda)``
    (default the low-pass prior ``1/(1+x)^2``) and white noise of power
    ``noise_power``; ``x_hat = h(L) (h(L) + sigma^2 I)^{-1} y`` with
    ``h = psd`` is computed by CG on the Gram operator of the
    ``sqrt(psd)`` filter, with no eigendecomposition.
    """
    if psd is None:
        def psd(x):
            return 1.0 / (1.0 + np.asarray(x, np.float64)) ** 2

    def sqrt_psd(x):
        return np.sqrt(np.maximum(psd(x), 0.0))

    filt = _as_filter(graph, [sqrt_psd], order, lmax)
    res = wiener(filt, y, noise_power, n_iters=n_iters, tol=tol,
                 backend=backend or "dense", **opts)
    return res if full_output else res.x


def inverse_filter(
    graph: SensorGraph,
    observations,
    lmax: float,
    *,
    bank: Sequence[Callable[[np.ndarray], np.ndarray]],
    order: int = 20,
    reg: float = 0.0,
    n_iters: int = 50,
    tol: float | None = 1e-6,
    backend: str | None = None,
    full_output: bool = False,
    **opts,
) -> torch.Tensor | SolveResult:
    """Inverse filtering (arXiv:2003.11152).

    Given observations ``b = Phi~ x``, the (eta,) + signal.shape outputs of
    the multiplier union ``bank``, recovers ``x`` from the normal
    equations ``(Phi~* Phi~ + reg I) x = Phi~* b`` by CG on the Gram
    operator: one adjoint up front, one degree-2M gram per iteration.
    """
    be = backend or "dense"
    filt = _as_filter(graph, list(bank), order, lmax)
    rhs = filt.adjoint(observations, backend=be, **opts)
    res = conjugate_gradient(
        GramProblem(filt=filt, b=rhs, reg=reg),
        n_iters=n_iters, tol=tol, backend=be, **opts)
    return res if full_output else res.x
