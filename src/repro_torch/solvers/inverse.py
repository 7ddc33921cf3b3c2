"""Inverse filtering via Chebyshev approximation of ``1/h(lambda)``.

Mirrors ``repro/solvers/inverse.py``. ``h`` is
known exactly as a Chebyshev series (the filter's ``gram_coeffs``), so its
regularized reciprocal is fit directly (arXiv:2504.14341): a low-order
series ``q(lambda) ~= 1 / (h(lambda) + reg)``, computed on the host by
:func:`repro_torch.core.chebyshev.inverse_coefficients` from coefficients
alone. The fit is used two ways:

* :func:`cheb_inverse` — the fixed-point iteration
  ``x <- x + q(L) (b - (h(L) + reg) x)``, error contracting by
  ``rho = max |1 - q(h + reg)|`` per sweep;
* :func:`cheb_preconditioner` — ``M^{-1} = q(L)`` handed to
  ``conjugate_gradient(preconditioner=...)``.

``q(L)`` is applied through :meth:`GraphFilter.apply_series`, reusing the
prepared backend state (on ``bsr``: one union launch, or the stepwise
chain). Both extend to multi-shift filters, where ``q`` is a joint tensor
series of per-shift order K fit on the tensor spectral grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import chebyshev
from repro_torch.filters import backend_is_traceable
from repro_torch.solvers.api import GramProblem, SolveResult, _cast
from repro_torch.solvers.loops import iterate

__all__ = ["ChebyshevPreconditioner", "cheb_preconditioner", "cheb_inverse"]


@dataclasses.dataclass(frozen=True)
class ChebyshevPreconditioner:
    """Polynomial preconditioner ``M^{-1} = q(L) ~= (h(L) + reg)^{-1}``.

    Built by :func:`cheb_preconditioner`; calling it applies the fitted
    series through the problem filter's prepared backend state.

    Attributes
    ----------
    problem : GramProblem
        The Gram system whose operator this preconditions.
    coeffs : numpy.ndarray
        The (K+1,) fitted series ``q`` (half-first-coefficient convention),
        a joint (K_1+1, ..., K_R+1) tensor for multi-shift filters.
    rate : float
        Contraction bound ``max |1 - q(h + reg)|`` over the spectral
        domain: the per-sweep error factor of :func:`cheb_inverse`.
    backend : str
        Backend the series is applied on.
    """

    problem: GramProblem
    coeffs: np.ndarray
    rate: float
    backend: str
    opts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def orders(self) -> tuple[int, ...]:
        """Orders of the fitted series (words accounting)."""
        return tuple(m - 1 for m in self.coeffs.shape)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.problem.filt.apply_series(r, self.coeffs, backend=self.backend, **self.opts)


def _fit_min(q: np.ndarray, lmaxes, *, grid: int = 2048) -> float:
    """Minimum of the fitted series ``q`` over the spectral domain (the
    tensor grid of ``max(64, round(grid^(1/R)))`` points per axis for a
    joint series)."""
    q = np.asarray(q)
    if q.ndim == 1:
        xs = np.linspace(0.0, float(lmaxes[0]), grid)
        vals = chebyshev.cheb_eval(q[np.newaxis], xs, float(lmaxes[0]))
    else:
        pts = max(64, round(grid ** (1.0 / q.ndim)))
        xs = [np.linspace(0.0, float(lm), pts) for lm in lmaxes]
        vals = chebyshev.cheb_eval_joint(q[np.newaxis], xs, list(lmaxes))
    return float(np.min(vals))


def cheb_preconditioner(
    problem: GramProblem,
    *,
    order: int = 8,
    max_order: int = 64,
    quad_points: int | None = None,
    backend: str = "dense",
    **opts,
) -> ChebyshevPreconditioner:
    """Fit ``q ~= 1/(h + reg)`` for a Gram system (arXiv:2504.14341).

    A usable preconditioner must be SPD (``q > 0`` on the domain) and
    contracting (``rate < 1``). Starting at ``order``, the fit order
    doubles until both hold, capped at ``max_order``, where a
    ``ValueError`` says the spectrum is too hard at that budget. Read the
    achieved order off ``ChebyshevPreconditioner.orders``.

    Parameters
    ----------
    problem : GramProblem
        The system ``(Phi~* Phi~ + reg I) x = b`` to precondition.
    order : int
        Starting fit order K (per shift for a multi-shift filter); each
        application costs K matvecs (per shift, the joint counts model).
    max_order : int
        Cap of the order doubling.
    quad_points : int, optional
        Quadrature nodes (default scales with ``order``).
    backend : str
        Backend the fitted series will be applied on.
    """
    filt = problem.filt
    single = filt.n_shifts == 1
    lmaxes = [filt.lmax] if single else list(filt.shift_lmaxes)
    k = int(order)
    while True:
        korder = k if single else [k] * filt.n_shifts
        q = chebyshev.inverse_coefficients(
            filt.gram_coeffs, lmaxes[0] if single else lmaxes, korder,
            reg=problem.reg, quad_points=quad_points,
        )
        rate = float(chebyshev.inverse_fixed_point_rate(
            q, filt.gram_coeffs, lmaxes[0] if single else lmaxes, reg=problem.reg
        ))
        if rate < 1.0 and _fit_min(q, lmaxes) > 0.0:
            break
        if k >= max_order:
            raise ValueError(
                f"cheb_preconditioner: no SPD contracting fit of "
                f"1/(h + {problem.reg:g}) up to order {max_order} "
                f"(rate {rate:.3f} at order {k}); the gram spectrum's "
                "dynamic range is too high — raise max_order or reg"
            )
        k = min(2 * k, max_order)
    return ChebyshevPreconditioner(
        problem=problem, coeffs=np.asarray(q), rate=rate, backend=backend, opts=opts
    )


def cheb_inverse(
    problem: GramProblem,
    *,
    order: int = 8,
    max_order: int = 64,
    x0=None,
    n_iters: int = 50,
    tol: float | None = 1e-6,
    backend: str = "dense",
    quad_points: int | None = None,
    **opts,
) -> SolveResult:
    """Fixed-point inverse filtering: ``x <- x + q(L) r``.

    Iterates ``r = b - (h(L) + reg) x;  x <- x + q(L) r`` from
    ``x_0 = q(L) b``; the error contracts by ``rho < 1`` every sweep, a
    rate known before the solve. History records the worst-column
    relative residual, on which ``tol`` stops. The result has
    ``method="cheb_inverse"``, the preconditioner in ``aux``, and
    per-iteration words of one degree-2M gram plus one degree-K ``q``.
    """
    pre = cheb_preconditioner(
        problem, order=order, max_order=max_order,
        quad_points=quad_points, backend=backend, **opts,
    )
    filt = problem.filt
    b = filt._signal(problem.b)
    mv = problem.operator(backend, **opts)
    x = pre(b) if x0 is None else _cast(filt._signal(x0), b)
    bnorm = torch.clamp(torch.sqrt(torch.sum(b * b, dim=0)), min=1e-30)

    def step(x):
        r = b - mv(x)
        rel = torch.max(torch.sqrt(torch.sum(r * r, dim=0)) / bnorm)
        return x + pre(r), (rel, rel)

    x, hist, k, conv = iterate(
        step, x, n_iters=n_iters, tol=tol, traceable=backend_is_traceable(backend),
        method="cheb_inverse",
    )
    words = filt.messages_per_apply(
        orders=tuple(2 * m for m in filt.orders), backend=backend, **opts
    ) + filt.messages_per_apply(orders=pre.orders, backend=backend, **opts)
    return SolveResult(
        x=x,
        aux=pre,
        history=hist,
        iterations=k,
        converged=conv,
        method="cheb_inverse",
        backend=backend,
        messages_per_iteration=words,
    )
