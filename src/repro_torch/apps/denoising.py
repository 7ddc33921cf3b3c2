"""Paper Sec. V applications: smoothing, Tikhonov denoising and
semi-supervised classification.

Mirrors ``repro/apps/denoising.py`` (the solver-backed apps come with the
solver slice). Each routine builds a :class:`GraphFilter` on the given
graph and runs on any registered backend; the signal stays on the
graph's device.
"""

from __future__ import annotations

import torch

from repro_torch.core import multipliers as mult
from repro_torch.core.graph import SensorGraph
from repro_torch.filters import GraphFilter

__all__ = ["smooth_heat", "denoise_tikhonov", "ssl_classify"]


def _as_filter(g: SensorGraph, bank, order: int, lmax: float):
    if not isinstance(g, SensorGraph):
        raise TypeError(f"expected a SensorGraph, got {type(g).__name__}")
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
