"""Warm-started streaming solvers (mirrors ``repro/stream/solvers.py``,
DESIGN.md Sec. 8).

Each frame's iterative solve is seeded with the previous frame's solution.
On a slowly varying scene the seed is already near the new optimum, so the
tolerance fires after fewer iterations than a cold start, and every
iteration saved is one forward + one adjoint (lasso) or one ``gram`` (CG)
saved. The carried solution stays on the stream's device.

Stateful lanes (:class:`StreamingLasso`, :class:`StreamingWiener`);
:func:`stream_ista` / :func:`stream_fista` / :func:`stream_wiener` are the
one-shot conveniences over a whole frame sequence.
"""

from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.filters import GraphFilter
from repro_torch.solvers import LassoProblem, SolveResult, fista, ista, wiener
from repro_torch.stream.api import stream_device, stream_frame

__all__ = [
    "StreamingLasso",
    "StreamingWiener",
    "stream_fista",
    "stream_ista",
    "stream_wiener",
]


class StreamingLasso:
    """Streaming SGWT-lasso: warm-start each frame at the last solution.

    Parameters mirror :class:`repro_torch.solvers.LassoProblem` plus the
    solver knobs; ``tol`` should be set (the budget mode runs ``n_iters``
    regardless of the seed). ``device`` as for ``StreamingFilter``.
    """

    def __init__(
        self,
        filt: GraphFilter,
        *,
        method: str = "fista",
        mu=1.0,
        step: float | None = None,
        n_iters: int = 200,
        tol: float | None = 1e-4,
        backend: str = "dense",
        device: str | torch.device | None = None,
        **opts,
    ):
        if method not in ("ista", "fista"):
            raise ValueError(f"method must be 'ista' or 'fista', got {method!r}")
        self.device = stream_device(filt, device)
        self.filt = filt
        self.method = method
        self.mu = mu
        self.step = step
        self.n_iters = n_iters
        self.tol = tol
        self.backend = backend
        self.opts = opts
        self._a = None

    def reset(self) -> None:
        """Drop the carried solution; the next push is a cold solve."""
        self._a = None

    def push(self, y) -> SolveResult:
        """Solve one frame, seeded with the previous frame's coefficients."""
        problem = LassoProblem(
            filt=self.filt, y=stream_frame(self.filt, self.device, y), mu=self.mu, step=self.step
        )
        fn = ista if self.method == "ista" else fista
        res = fn(
            problem,
            a0=self._a,
            n_iters=self.n_iters,
            tol=self.tol,
            backend=self.backend,
            **self.opts,
        )
        self._a = res.aux
        return res


class StreamingWiener:
    """Streaming Wiener reconstruction: warm-start CG at the last latent.

    :func:`repro_torch.solvers.wiener` returns the pre-``gram`` latent
    ``(G + sigma^2 I)^{-1} y`` in ``aux``; that latent (not the estimate)
    is the CG variable, so it seeds the next frame.
    """

    def __init__(
        self,
        filt: GraphFilter,
        noise_power: float,
        *,
        n_iters: int = 200,
        tol: float | None = 1e-6,
        backend: str = "dense",
        device: str | torch.device | None = None,
        **opts,
    ):
        self.device = stream_device(filt, device)
        self.filt = filt
        self.noise_power = float(noise_power)
        self.n_iters = n_iters
        self.tol = tol
        self.backend = backend
        self.opts = opts
        self._latent = None

    def reset(self) -> None:
        """Drop the carried latent; the next push is a cold solve."""
        self._latent = None

    def push(self, y) -> SolveResult:
        """Reconstruct one frame, seeded with the previous frame's latent."""
        res = wiener(
            self.filt,
            stream_frame(self.filt, self.device, y),
            self.noise_power,
            x0=self._latent,
            n_iters=self.n_iters,
            tol=self.tol,
            backend=self.backend,
            **self.opts,
        )
        self._latent = res.aux
        return res


def stream_ista(filt: GraphFilter, frames: Iterable, **kw) -> list[SolveResult]:
    """Warm-started ISTA over a frame sequence (one result per frame)."""
    lane = StreamingLasso(filt, method="ista", **kw)
    return [lane.push(y) for y in frames]


def stream_fista(filt: GraphFilter, frames: Iterable, **kw) -> list[SolveResult]:
    """Warm-started FISTA over a frame sequence (one result per frame)."""
    lane = StreamingLasso(filt, method="fista", **kw)
    return [lane.push(y) for y in frames]


def stream_wiener(
    filt: GraphFilter, frames: Iterable, noise_power: float, **kw
) -> list[SolveResult]:
    """Warm-started Wiener reconstruction over a frame sequence."""
    lane = StreamingWiener(filt, noise_power, **kw)
    return [lane.push(y) for y in frames]
