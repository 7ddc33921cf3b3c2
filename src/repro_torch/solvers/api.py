"""Problem definitions and results for the port's solver layer.

Mirrors ``repro/solvers/api.py``. The paper's Sec. V-C application is an
iterative algorithm whose every step is one forward ``Phi~`` and/or one
adjoint ``Phi~*`` through the Chebyshev recurrence. Two problems are
solved on top of :class:`repro_torch.filters.GraphFilter`:

* :class:`LassoProblem` — ``argmin_a 1/2 ||y - Phi~* a||^2 + ||a||_{1,mu}``
  (paper eq. 20/21, the SGWT denoising experiment), by ``ista``/``fista``;
* :class:`GramProblem` — ``(Phi~* Phi~ + reg I) x = b`` (inverse
  filtering, arXiv:2003.11152, and graph Wiener reconstruction,
  arXiv:2205.04019), by ``conjugate_gradient``; each iteration is one
  ``GraphFilter.gram``, a single degree-2M filter.

Signals are tensors on the filter's device; a numpy signal is placed on
the bound graph's device as float32 (``GraphFilter._signal``). Host-side
scalars (``mu``, ``reg``) enter torch through an explicit cast to the
signal's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import cached_upload
from repro_torch.filters import GraphFilter

__all__ = ["SolveResult", "LassoProblem", "GramProblem"]


def _cast(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a tensor of ``like``'s dtype and device (explicit cast:
    a float64 host scalar must not promote a float32 solve). A host scalar
    becomes a device fill and a host array a once-per-content upload, so
    no call makes a host-to-device copy (which synchronises the stream and
    cannot run inside a recorded CUDA graph)."""
    if isinstance(value, torch.Tensor):
        if value.device != like.device:
            raise ValueError(f"tensor is on {value.device}, the signal on {like.device}")
        return value.to(like.dtype)
    arr = np.asarray(value)
    if arr.ndim == 0:
        return torch.full((), arr.item(), dtype=like.dtype, device=like.device)
    if like.device.type == "cuda":
        return cached_upload(arr, like.device, like.dtype)
    return torch.as_tensor(arr, device=like.device).to(like.dtype)


@dataclasses.dataclass
class SolveResult:
    """Outcome of an iterative solve on a ``GraphFilter``.

    Attributes
    ----------
    x : torch.Tensor
        The solution in the problem's primal variable: the recovered
        signal for every shipped problem (lasso returns ``Phi~* a``).
    aux : object
        The coefficients ``a`` for lasso, the latent ``z`` for Wiener
        reconstruction, the preconditioner for ``cheb_inverse``, None for
        plain CG.
    history : numpy.ndarray
        (iterations,) float64 per-iteration trace: the lasso objective,
        or the CG residual norm (worst column for panel solves).
    iterations : int
        Iterations executed (< ``n_iters`` on early stop).
    converged : bool
        True when the tolerance fired, or when no tolerance was requested
        and the budget ran.
    method, backend : str
        Which solver produced this, on which backend.
    messages_per_iteration : int
        Words exchanged between workers per iteration for one (N,) signal,
        from the backend's ``messages_per_apply`` model (0 on every
        backend of the port so far: they run on one device).
    """

    x: torch.Tensor
    aux: Any
    history: np.ndarray
    iterations: int
    converged: bool
    method: str
    backend: str
    messages_per_iteration: int

    @property
    def messages_total(self) -> int:
        """Total solve communication: iterations x words/iteration."""
        return self.iterations * self.messages_per_iteration


@dataclasses.dataclass
class LassoProblem:
    """``argmin_a 1/2 ||y - Phi~* a||^2 + ||a||_{1,mu}`` (paper Sec. V-C).

    Parameters
    ----------
    filt : GraphFilter
        The union ``Phi~`` (for SGWT denoising the wavelet frame,
        eta = n_scales + 1).
    y : torch.Tensor or numpy.ndarray
        (N,) observation or (N, F) panel of independent observations.
    mu : float or tensor
        l1 weights. A scalar penalizes only the wavelet bands: band 0, the
        low-pass scaling band, gets ``mu_0 = 0``. An (eta,) vector gives
        full control.
    step : float, optional
        Gradient step tau; defaults to ``1 / ||Phi~||^2`` via
        ``filt.operator_norm_bound()``.
    """

    filt: GraphFilter
    y: Any
    mu: Any = 1.0
    step: float | None = None

    def step_size(self) -> float:
        if self.step is not None:
            return float(self.step)
        return 1.0 / self.filt.operator_norm_bound()

    def mu_vector(self) -> torch.Tensor:
        """(eta,) + (1,)*y.ndim broadcastable l1 weight vector."""
        y = self.filt._signal(self.y)
        mu = _cast(self.mu, y)
        eta = self.filt.eta
        if mu.ndim == 0:
            mu = torch.cat([torch.zeros(1, dtype=y.dtype, device=y.device), mu.expand(eta - 1)])
        if tuple(mu.shape) != (eta,):
            raise ValueError(f"mu must be scalar or shape ({eta},), got {tuple(mu.shape)}")
        return mu.reshape((eta,) + (1,) * y.ndim)

    def objective(self, a, *, backend: str = "dense", **opts) -> float:
        """Exact lasso objective of coefficients ``a`` (one adjoint)."""
        y = self.filt._signal(self.y)
        a = self.filt._signal(a)
        resid = y - self.filt.adjoint(a, backend=backend, **opts)
        return float(0.5 * torch.sum(resid * resid) + torch.sum(self.mu_vector() * torch.abs(a)))

    def messages_per_iteration(self, backend: str, **opts) -> int:
        """One length-1 forward + one length-eta adjoint per iteration
        (Sec. V-C): ``m * (1 + eta)`` words with m = words/apply."""
        m = self.filt.messages_per_apply(backend=backend, **opts)
        return m * (1 + self.filt.eta)


@dataclasses.dataclass
class GramProblem:
    """Regularized normal equations ``(Phi~* Phi~ + reg I) x = b``.

    ``reg = 0`` is pure inverse filtering on the Gram operator;
    ``reg = noise_power`` the Wiener/Tikhonov variant. Each CG iteration
    costs one ``GraphFilter.gram``, a single degree-2M filter.

    Parameters
    ----------
    filt : GraphFilter
        The filter whose Gram operator is inverted.
    b : torch.Tensor or numpy.ndarray
        (N,) or (N, F) right-hand side(s), typically ``Phi~* obs``.
    reg : float
        Ridge term added to the Gram operator.
    """

    filt: GraphFilter
    b: Any
    reg: float = 0.0

    def operator(self, backend: str, **opts):
        """The SPD map ``v -> (Phi~* Phi~ + reg I) v`` on ``backend``."""
        reg = _cast(self.reg, self.filt._signal(self.b))

        def mv(v):
            return self.filt.gram(v, backend=backend, **opts) + reg * v

        return mv

    def messages_per_iteration(self, backend: str, **opts) -> int:
        """One degree-2M gram filter per CG iteration."""
        return self.filt.messages_per_apply(
            orders=tuple(2 * m for m in self.filt.orders), backend=backend, **opts
        )
