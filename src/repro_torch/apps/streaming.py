"""Streaming applications: denoise a *sequence* of sensor frames.

Mirrors ``repro/apps/streaming.py``: the frame-sequence versions of the
Sec. V applications on the streaming subsystem (DESIGN.md Sec. 8).
Tikhonov denoising rides :class:`repro_torch.stream.StreamingFilter`
(delta filtering), SGWT-lasso denoising rides
:class:`repro_torch.stream.StreamingLasso` (warm-started solves). Outputs
stay on the graph's device.
"""

from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.core import multipliers as mult
from repro_torch.core.graph import SensorGraph
from repro_torch.filters import GraphFilter
from repro_torch.solvers import SolveResult
from repro_torch.stream import FrameResult, StreamingFilter, StreamingLasso

__all__ = ["streaming_denoise", "streaming_wavelet_denoise"]


def streaming_denoise(
    graph: SensorGraph,
    frames: Iterable,
    lmax: float | None = None,
    tau: float = 1.0,
    r: int = 1,
    order: int = 20,
    *,
    backend: str = "dense",
    max_delta_frac: float = 0.25,
    refresh_every: int | None = None,
    n_parts: int | None = None,
    device: str | torch.device | None = None,
    **opts,
) -> tuple[torch.Tensor, list[FrameResult]]:
    """Tikhonov-denoise a frame stream with delta filtering.

    The Sec. V-B denoiser applied per frame, but frame t+1 only pays for
    the vertices that changed since frame t (plus their order-hop
    neighbourhood). ``device`` (default ``cuda``, raising without it) must
    be the graph's. Returns ``(outputs, results)``: (T, N) stacked
    denoised frames and the per-frame :class:`FrameResult` records.
    """
    filt = GraphFilter.from_multipliers([mult.tikhonov(tau, r)], order, graph=graph, lmax=lmax)
    lane = StreamingFilter(
        filt,
        backend=backend,
        max_delta_frac=max_delta_frac,
        refresh_every=refresh_every,
        n_parts=n_parts,
        opts=opts,
        device=device,
    )
    results = [lane.push(f) for f in frames]
    outputs = torch.stack([res.out[0] for res in results])
    return outputs, results


def streaming_wavelet_denoise(
    graph: SensorGraph,
    frames: Iterable,
    lmax: float | None = None,
    *,
    n_scales: int = 4,
    order: int = 20,
    mu: float = 1.0,
    method: str = "fista",
    n_iters: int = 200,
    tol: float | None = 1e-4,
    backend: str = "dense",
    device: str | torch.device | None = None,
    **opts,
) -> tuple[torch.Tensor, list[SolveResult]]:
    """SGWT-lasso denoise a frame stream with warm-started solves.

    The Sec. V-C denoiser per frame, each solve seeded with the previous
    frame's wavelet coefficients. Returns ``(estimates, results)``: (T, N)
    denoised frames plus per-frame :class:`SolveResult` records.
    """
    if lmax is None:
        lmax = float(graph.lmax_bound())
    filt = GraphFilter.from_multipliers(
        mult.sgwt_filter_bank(lmax, n_scales=n_scales), order, graph=graph, lmax=lmax
    )
    lane = StreamingLasso(
        filt,
        method=method,
        mu=mu,
        n_iters=n_iters,
        tol=tol,
        backend=backend,
        device=device,
        **opts,
    )
    results = [lane.push(f) for f in frames]
    estimates = torch.stack([res.x for res in results])
    return estimates, results
