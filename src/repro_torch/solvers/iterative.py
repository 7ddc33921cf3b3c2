"""The solvers: ISTA, FISTA, conjugate gradient, Wiener reconstruction.

Mirrors ``repro/solvers/iterative.py``. All four run entirely on
:class:`repro_torch.filters.GraphFilter` calls — one forward and one
adjoint (lasso) or one ``gram`` (CG) per iteration — so on ``bsr`` their
filter applies go through the union kernel (or the step kernel on the
stepwise route). How the loop records its history follows the backend's
``traceable`` capability (:mod:`repro_torch.solvers.loops`).

* ``ista``  — paper eq. 21 verbatim.
* ``fista`` — the same per-iteration work with Nesterov momentum:
  O(1/k^2) objective decay instead of O(1/k).
* ``conjugate_gradient`` — inverse filtering on the Gram operator
  (arXiv:2003.11152), PCG with ``preconditioner=``.
* ``wiener`` — ``x = G (G + sigma^2 I)^{-1} y`` with ``G = Phi~* Phi~``
  (arXiv:2205.04019), via CG.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.filters import GraphFilter, backend_is_traceable
from repro_torch.solvers.api import GramProblem, LassoProblem, SolveResult, _cast
from repro_torch.solvers.loops import iterate, run_loop, stacked_f32

__all__ = [
    "ista",
    "fista",
    "conjugate_gradient",
    "wiener",
    "solve",
    "lasso_panel_program",
]


def _lasso_setup(problem: LassoProblem, backend: str, opts: dict):
    filt = problem.filt
    y = filt._signal(problem.y)
    tau = _cast(problem.step_size(), y)
    muv = problem.mu_vector()
    thresh = muv * tau

    def fwd(v):
        return filt.apply(v, backend=backend, **opts)

    def adj(a):
        return filt.adjoint(a, backend=backend, **opts)

    def soft(z):
        return torch.sign(z) * torch.clamp(torch.abs(z) - thresh, min=0.0)

    def l1(a):
        return torch.sum(muv * torch.abs(a))

    return y, tau, fwd, adj, soft, l1


def _relative_change(obj_prev, obj):
    return torch.abs(obj_prev - obj) / torch.clamp(torch.abs(obj), min=1.0)


def _ista_machine(y, tau, fwd, adj, soft, l1):
    """ISTA as (step, init, final): the eq. 21 update, shared by the
    solvers and the panel program."""

    def step(state):
        a, obj_prev = state
        r = y - adj(a)
        obj = 0.5 * torch.sum(r * r) + l1(a)
        a_new = soft(a + tau * fwd(r))
        return (a_new, obj), (obj, _relative_change(obj_prev, obj))

    def init(a0):
        return (a0, _cast(float("inf"), y))

    def final(state):
        return state[0]

    return step, init, final


def _fista_machine(y, tau, fwd, adj, soft, l1):
    """FISTA as (step, init, final); see :func:`_ista_machine`."""

    def step(state):
        a_prev, z, t, obj_prev = state
        r = y - adj(z)
        obj = 0.5 * torch.sum(r * r) + l1(z)
        a = soft(z + tau * fwd(r))
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z_new = a + ((t - 1.0) / t_new) * (a - a_prev)
        return (a, z_new, t_new, obj), (obj, _relative_change(obj_prev, obj))

    def init(a0):
        return (a0, a0, _cast(1.0, y), _cast(float("inf"), y))

    def final(state):
        return state[0]

    return step, init, final


_LASSO_MACHINES = {"ista": _ista_machine, "fista": _fista_machine}


def _lasso_result(problem, a, hist, k, conv, method, backend, opts):
    return SolveResult(
        x=problem.filt.adjoint(a, backend=backend, **opts),
        aux=a,
        history=hist,
        iterations=k,
        converged=conv,
        method=method,
        backend=backend,
        messages_per_iteration=problem.messages_per_iteration(backend, **opts),
    )


def _lasso(method, problem, a0, n_iters, tol, backend, opts) -> SolveResult:
    y, tau, fwd, adj, soft, l1 = _lasso_setup(problem, backend, opts)
    a0 = fwd(y) if a0 is None else _cast(problem.filt._signal(a0), y)
    step, init, final = _LASSO_MACHINES[method](y, tau, fwd, adj, soft, l1)
    state, hist, k, conv = iterate(
        step, init(a0), n_iters=n_iters, tol=tol, traceable=backend_is_traceable(backend),
        method=method,
    )
    return _lasso_result(problem, final(state), hist, k, conv, method, backend, opts)


def ista(
    problem: LassoProblem,
    *,
    a0=None,
    n_iters: int = 50,
    tol: float | None = None,
    backend: str = "dense",
    **opts,
) -> SolveResult:
    """Iterative soft thresholding (paper eq. 21).

    ``a <- S_{mu tau}(a + tau Phi~ (y - Phi~* a))``, started at
    ``a0 = Phi~ y`` by default; ``a0=`` warm-starts. History records the
    objective of each incoming iterate (from the residual the update
    needs anyway); ``tol`` stops on its relative change.
    """
    return _lasso("ista", problem, a0, n_iters, tol, backend, opts)


def fista(
    problem: LassoProblem,
    *,
    a0=None,
    n_iters: int = 50,
    tol: float | None = None,
    backend: str = "dense",
    **opts,
) -> SolveResult:
    """FISTA (Beck & Teboulle 2009): ISTA + Nesterov momentum.

    The same per-iteration work as :func:`ista` (one forward, one
    adjoint) with O(1/k^2) objective decay. The proximal step is taken at
    the extrapolated point ``z``; history records the objective at ``z``.
    ``a0=`` warm-starts (momentum restarts at t = 1).
    """
    return _lasso("fista", problem, a0, n_iters, tol, backend, opts)


def _colsum(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column inner product: scalar for (N,), (F,) for (N, F)."""
    return torch.sum(u * v, dim=0)


def conjugate_gradient(
    problem: GramProblem,
    *,
    x0=None,
    n_iters: int = 50,
    tol: float | None = 1e-6,
    backend: str = "dense",
    preconditioner=None,
    **opts,
) -> SolveResult:
    """CG on ``(Phi~* Phi~ + reg I) x = b`` (arXiv:2003.11152).

    Each iteration is one ``GraphFilter.gram`` call. Panel right-hand
    sides (N, F) are F independent systems: step sizes are per column and
    the tolerance applies to the worst column's relative residual, whose
    norm the history records.

    ``preconditioner=`` enables PCG with a callable ``r -> M^{-1} r``
    applied once per iteration, canonically a
    :class:`repro_torch.solvers.ChebyshevPreconditioner`; when it
    declares ``orders`` its words are added to
    ``messages_per_iteration``. The tolerance stays on the true residual.
    """
    b = problem.filt._signal(problem.b)
    mv = problem.operator(backend, **opts)
    x = torch.zeros_like(b) if x0 is None else _cast(problem.filt._signal(x0), b)
    r = b - mv(x)
    bnorm = torch.clamp(torch.sqrt(_colsum(b, b)), min=1e-30)
    eps = _cast(1e-30, b)
    precond = preconditioner if preconditioner is not None else (lambda v: v)

    def step(state):
        x, r, p, rz = state
        ap = mv(p)
        alpha = rz / torch.maximum(_colsum(p, ap), eps)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _colsum(r, z)
        p = z + (rz_new / torch.maximum(rz, eps)) * p
        rs_new = _colsum(r, r)
        rel = torch.sqrt(rs_new) / bnorm
        return (x, r, p, rz_new), (torch.max(torch.sqrt(rs_new)), torch.max(rel))

    z0 = precond(r)
    init = (x, r, z0, _colsum(r, z0))
    (x, _, _, _), hist, k, conv = iterate(
        step, init, n_iters=n_iters, tol=tol, traceable=backend_is_traceable(backend),
        method="cg",
    )
    words = problem.messages_per_iteration(backend, **opts)
    pre_orders = getattr(preconditioner, "orders", None)
    if pre_orders is not None:
        words += problem.filt.messages_per_apply(orders=pre_orders, backend=backend, **opts)
    return SolveResult(
        x=x,
        aux=None,
        history=hist,
        iterations=k,
        converged=conv,
        method="cg" if preconditioner is None else "pcg",
        backend=backend,
        messages_per_iteration=words,
    )


def wiener(
    filt: GraphFilter,
    y,
    noise_power: float,
    *,
    x0=None,
    n_iters: int = 50,
    tol: float | None = 1e-6,
    backend: str = "dense",
    **opts,
) -> SolveResult:
    """Graph Wiener reconstruction (arXiv:2205.04019).

    With ``filt`` built from ``sqrt(h)`` for a signal PSD ``h`` (so the
    Gram operator is ``G = h(L)``), the estimate from ``y = x + n``,
    ``n ~ N(0, sigma^2 I)``, is ``x_hat = G (G + sigma^2 I)^{-1} y``: one
    CG solve plus one final ``gram``. Returns the estimate in ``x`` and
    the latent ``(G + sigma^2)^{-1} y`` in ``aux``; ``x0=`` warm-starts
    the CG solve from a previous latent.
    """
    res = conjugate_gradient(
        GramProblem(filt=filt, b=y, reg=float(noise_power)),
        x0=x0,
        n_iters=n_iters,
        tol=tol,
        backend=backend,
        **opts,
    )
    xhat = filt.gram(res.x, backend=backend, **opts)
    return dataclasses.replace(res, x=xhat, aux=res.x, method="wiener")


def lasso_panel_program(
    filt: GraphFilter,
    *,
    method: str = "fista",
    mu=1.0,
    step: float | None = None,
    n_iters: int = 40,
    backend: str = "dense",
    **opts,
):
    """Build a whole-solve panel function for a fixed budget.

    Returns ``y (N, F) -> (x, a, history)`` running the complete
    ``method`` lasso solve: ``x`` the (N, F) denoised panel, ``a`` the
    (eta, N, F) coefficients, ``history`` the (n_iters,) float32
    panel-summed objective trace, kept on the device. Where the reference
    stages one pure program for ``jax.jit``, the port returns a plain
    function with no early exit and no host synchronisation, which the
    serving layer records as one CUDA graph (its scalars are device fills
    and its coefficients once-per-content uploads, so nothing copies from
    the host inside the recorded region). Requires a ``traceable``
    backend, as the reference does.
    """
    if not backend_is_traceable(backend):
        raise ValueError(
            f"lasso_panel_program needs a traceable backend; {backend!r} "
            "stages host transfers (use ista/fista's host loop instead)"
        )
    try:
        machine = _LASSO_MACHINES[method]
    except KeyError:
        raise ValueError(f"unknown lasso method {method!r}; use 'ista' or 'fista'") from None
    filt.prepare_backend(backend, **opts)

    def run(y):
        problem = LassoProblem(filt=filt, y=y, mu=mu, step=step)
        y2, tau, fwd, adj, soft, l1 = _lasso_setup(problem, backend, opts)
        stepf, init, final = machine(y2, tau, fwd, adj, soft, l1)
        state, traces, _ = run_loop(stepf, init(fwd(y2)), n_iters, method=method)
        a = final(state)
        return filt.adjoint(a, backend=backend, **opts), a, stacked_f32(traces, y2.device)

    return run


def solve(problem, *, method: str | None = None, **kw) -> SolveResult:
    """Dispatch a problem to its solver by name.

    ``LassoProblem`` takes ``method`` in {"ista", "fista"} (default
    "fista"); ``GramProblem`` takes only "cg".
    """
    if isinstance(problem, LassoProblem):
        method = method or "fista"
        try:
            fn = {"ista": ista, "fista": fista}[method]
        except KeyError:
            raise ValueError(f"unknown lasso method {method!r}; use 'ista' or 'fista'") from None
        return fn(problem, **kw)
    if isinstance(problem, GramProblem):
        if method not in (None, "cg"):
            raise ValueError(f"GramProblem solves via 'cg', got {method!r}")
        return conjugate_gradient(problem, **kw)
    raise TypeError(f"unknown problem type {type(problem).__name__}")
