"""Shifted-Chebyshev approximation of graph Fourier multipliers.

Mirrors ``repro/core/chebyshev.py``:

* eq. (8)  — Chebyshev coefficients ``c_{j,k}`` by Chebyshev--Gauss
  quadrature (host numpy float64, identical to the reference),
* eq. (9)  — the recurrence
  ``Tbar_k(L) f = (2/alpha)(L - alpha I) Tbar_{k-1}(L) f - Tbar_{k-2}(L) f``
  evaluated with matvecs against ``L`` (a Python loop where the reference
  has ``lax.scan``),
* eq. (11) — the union combine over one shared Krylov sequence,
* Sec. IV-C — the product identity behind the degree-2M Gram series,
* the inverse fit ``q ~= 1/(h + reg)`` behind ``solvers/inverse.py``
  (host numpy float64, identical to the reference; it evaluates ``h``
  through the tensor-grid evaluator ``cheb_eval_joint`` even for one
  shift),
* multi-shift joint polynomials of R commuting shifts (arXiv:2003.11152):
  the joint coefficient functions (host numpy float64, identical to the
  reference) and the joint recurrences ``cheb_apply_joint`` /
  ``cheb_adjoint_apply_joint``, which peel the leading shift axes and run
  a single-shift apply at the innermost level.

Coefficients are float64 numpy; every apply casts them explicitly to the
signal's dtype and device, as the reference does, so a float32 signal is
never promoted to float64.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import cached_upload

__all__ = [
    "cheb_coefficients",
    "cheb_eval",
    "cheb_eval_joint",
    "cheb_apply",
    "cheb_apply_krylov",
    "cheb_apply_dense",
    "cheb_adjoint_apply",
    "cheb_apply_joint",
    "cheb_adjoint_apply_joint",
    "product_coefficients",
    "gram_coefficients",
    "joint_product_coefficients",
    "joint_gram_coefficients",
    "separable_joint_coefficients",
    "inverse_coefficients",
    "inverse_fixed_point_rate",
]

Matvec = Callable[[torch.Tensor], torch.Tensor]


def cheb_coefficients(
    multipliers: Sequence[Callable[[np.ndarray], np.ndarray]],
    order: int,
    lmax: float,
    quad_points: int | None = None,
) -> np.ndarray:
    """Chebyshev coefficients of shifted multipliers — paper eq. (8).

    ``c_{j,k} = (2/pi) \\int_0^pi cos(k th) g_j(alpha (cos th + 1)) dth``
    with ``alpha = lmax / 2``, by midpoint quadrature at ``quad_points``
    nodes (default ``max(order + 1, 64) * 4``).

    Returns:
      float64 array of shape (eta, M+1).
    """
    if order < 1:
        raise ValueError(f"Chebyshev order must be >= 1, got {order}")
    p = quad_points or max(order + 1, 64) * 4
    alpha = lmax / 2.0
    theta = np.pi * (np.arange(p) + 0.5) / p  # Chebyshev-Gauss nodes
    x = alpha * (np.cos(theta) + 1.0)  # mapped to [0, lmax]
    k = np.arange(order + 1)
    basis = np.cos(np.outer(k, theta))  # (M+1, P)
    coeffs = np.stack(
        [(2.0 / p) * (basis @ np.asarray(g(x), dtype=np.float64)) for g in multipliers]
    )
    return coeffs


def cheb_eval(coeffs: np.ndarray, x: np.ndarray, lmax: float) -> np.ndarray:
    """Evaluate truncated shifted-Chebyshev series at scalar points ``x``.

    Convention (paper eq. 7): ``g(x) ~= c_0 / 2 + sum_{k>=1} c_k Tbar_k(x)``.
    Returns (eta, len(x)), or (len(x),) for 1-D coeffs.
    """
    c = np.atleast_2d(np.asarray(coeffs, dtype=np.float64))
    x = np.asarray(x, dtype=np.float64)
    alpha = lmax / 2.0
    y = (x - alpha) / alpha  # shift to [-1, 1]
    t_prev2 = np.ones_like(y)
    t_prev1 = y
    out = 0.5 * c[:, :1] * t_prev2 + (c[:, 1:2] * t_prev1 if c.shape[1] > 1 else 0.0)
    for k in range(2, c.shape[1]):
        t_k = 2.0 * y * t_prev1 - t_prev2
        out = out + c[:, k : k + 1] * t_k
        t_prev2, t_prev1 = t_prev1, t_k
    return out if np.asarray(coeffs).ndim == 2 else out[0]


def cheb_eval_joint(
    coeffs: np.ndarray, xs: Sequence[np.ndarray], lmaxes: Sequence[float]
) -> np.ndarray:
    """Evaluate a joint series on the tensor grid ``xs[0] x ... x xs[R-1]``.

    Args:
      coeffs: (eta, M_1+1, ..., M_R+1) joint coefficient tensor.
      xs: per-axis evaluation points, each within [0, lmaxes[r]].

    Returns: (eta, len(xs[0]), ..., len(xs[R-1])) evaluations with the
    per-axis half-first-coefficient convention.
    """
    c = np.asarray(coeffs, dtype=np.float64)
    n_shifts = len(xs)
    if c.ndim != n_shifts + 1:
        raise ValueError(
            f"joint coeffs must have ndim R+1 = {n_shifts + 1}, "
            f"got shape {c.shape}"
        )
    out = c
    for r in range(n_shifts):
        basis = _cheb_basis(c.shape[1 + r] - 1, xs[r], lmaxes[r])
        basis[0] *= 0.5  # half convention on this axis
        # contract axis 1 (the current leading shift axis); the grid axis
        # lands at the end, so axis order is preserved overall.
        out = np.tensordot(out, basis, axes=[[1], [0]])
    return out


def _cheb_basis(order: int, x: np.ndarray, lmax: float) -> np.ndarray:
    """(M+1, len(x)) matrix of shifted Chebyshev values ``Tbar_k(x)``."""
    x = np.asarray(x, dtype=np.float64)
    alpha = lmax / 2.0
    y = (x - alpha) / alpha
    basis = np.empty((order + 1, len(x)))
    basis[0] = 1.0
    if order >= 1:
        basis[1] = y
    for k in range(2, order + 1):
        basis[k] = 2.0 * y * basis[k - 1] - basis[k - 2]
    return basis


def _cast_coeffs(coeffs, like: torch.Tensor) -> torch.Tensor:
    """Coefficients as a tensor of ``like``'s dtype and device (explicit
    cast: float64 numpy must not promote a float32 recurrence). Host
    coefficients go to a CUDA device once per distinct array
    (``cached_upload``), so an apply makes no host-to-device copy."""
    if isinstance(coeffs, torch.Tensor):
        return coeffs.to(device=like.device, dtype=like.dtype)
    if like.device.type == "cuda":
        return cached_upload(np.asarray(coeffs), like.device, like.dtype)
    return torch.as_tensor(np.asarray(coeffs), device=like.device).to(like.dtype)


def _alpha(lmax, like: torch.Tensor) -> torch.Tensor:
    """``lmax / 2`` as a 0-d tensor of ``like``'s dtype, made on its device
    (a fill, not a host-to-device copy, which would synchronise)."""
    return torch.full((), float(lmax), dtype=like.dtype, device=like.device) / 2.0


def _outer(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(eta,) x t -> (eta,) + t.shape broadcasted product."""
    return c.reshape(c.shape + (1,) * t.ndim) * t[None]


def cheb_apply(
    matvec: Matvec,
    f: torch.Tensor,
    coeffs,
    lmax: float,
) -> torch.Tensor:
    """Apply a union of Chebyshev-approximated multipliers: ``Phi~ f``.

    Args:
      matvec: linear map computing ``L @ v`` for v shaped like ``f``.
      f: (N,) or (N, F) signal(s).
      coeffs: (eta, M+1) Chebyshev coefficients (paper convention).
      lmax: spectrum upper bound used to shift the polynomials.

    Returns:
      (eta,) + f.shape stacked outputs ``[Psi~_1 f, ..., Psi~_eta f]``.
    """
    out, _ = _recurrence(matvec, f, coeffs, lmax, keep=False)
    return out


def cheb_apply_krylov(
    matvec: Matvec,
    f: torch.Tensor,
    coeffs,
    lmax: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cheb_apply`` that also returns the Krylov stack ``{Tbar_k(L) f}``
    with shape ``(M+1,) + f.shape``."""
    out, ts = _recurrence(matvec, f, coeffs, lmax, keep=True)
    return out, torch.stack(ts)


def _recurrence(matvec, f, coeffs, lmax, *, keep: bool):
    coeffs = _cast_coeffs(coeffs, f)
    alpha = _alpha(lmax, f)
    t0 = f  # Tbar_0(L) f = f
    t1 = (matvec(f) - alpha * f) / alpha  # Tbar_1(L) f = (L - aI) f / a
    acc = _outer(0.5 * coeffs[:, 0], t0) + _outer(coeffs[:, 1], t1)
    ts = [t0, t1] if keep else None
    t_prev1, t_prev2 = t1, t0
    for k in range(2, coeffs.shape[1]):
        t_k = (2.0 / alpha) * (matvec(t_prev1) - alpha * t_prev1) - t_prev2
        acc = acc + _outer(coeffs[:, k], t_k)
        if keep:
            ts.append(t_k)
        t_prev1, t_prev2 = t_k, t_prev1
    return acc, ts


def cheb_apply_dense(
    laplacian_matrix: torch.Tensor,
    f: torch.Tensor,
    coeffs,
    lmax: float,
) -> torch.Tensor:
    """Convenience wrapper: ``cheb_apply`` with a dense Laplacian."""
    return cheb_apply(lambda v: laplacian_matrix @ v, f, coeffs, lmax)


def cheb_adjoint_apply(
    matvec: Matvec,
    a: torch.Tensor,
    coeffs,
    lmax: float,
) -> torch.Tensor:
    """Apply the adjoint ``Phi~* a`` — paper eq. (13).

    The same recurrence runs on the eta blocks stacked along a trailing
    axis and contracts against the coefficients over (j, k).

    Args:
      a: (eta, N) or (eta, N, F) stacked coefficient signals.

    Returns: (N,) or (N, F) adjoint output.
    """
    coeffs = _cast_coeffs(coeffs, a)
    eta = coeffs.shape[0]
    if a.shape[0] != eta:
        raise ValueError(f"adjoint input has {a.shape[0]} blocks, coeffs {eta}")
    v = torch.movedim(a, 0, -1)  # (N, [F,] eta)
    alpha = _alpha(lmax, a)
    t0 = v
    t1 = (matvec(v) - alpha * v) / alpha
    acc = t0 @ (0.5 * coeffs[:, 0]) + t1 @ coeffs[:, 1]
    t_prev1, t_prev2 = t1, t0
    for k in range(2, coeffs.shape[1]):
        t_k = (2.0 / alpha) * (matvec(t_prev1) - alpha * t_prev1) - t_prev2
        acc = acc + t_k @ coeffs[:, k]
        t_prev1, t_prev2 = t_k, t_prev1
    return acc


# ---- multi-shift (joint) polynomial filters --------------------------------
#
# A joint filter over R commuting shifts (S_1, ..., S_R) is
#   P = sum_{k_1..k_R} c[j, k_1, .., k_R] sigma_{k_1} Tbar_{k_1}(S_1) ...
#       sigma_{k_R} Tbar_{k_R}(S_R)
# with the half convention per axis (sigma_0 = 1/2). Evaluation recurses
# over the shift axes: shift r's recurrence restarts once per outer Krylov
# vector, so it performs M_r * prod_{s<r} (M_s + 1) matvecs.


def cheb_apply_joint(
    matvecs: Sequence[Matvec],
    f: torch.Tensor,
    coeffs,
    lmaxes: Sequence[float],
    *,
    inner: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Apply a joint polynomial of R commuting shifts: ``P(S_1..S_R) f``.

    Args:
      matvecs: R linear maps, ``matvecs[r](v) = S_r @ v`` for v shaped
        like ``f``.
      f: (N,) or (N, F) signal(s).
      coeffs: (eta, M_1+1, ..., M_R+1) joint coefficient tensor.
      lmaxes: per-shift spectrum bounds.
      inner: optional innermost level, ``inner(v, c)`` for a Krylov
        vector ``v`` of the outer shifts and a contiguous (eta, M_R+1)
        coefficient slice, returning ``(eta,) + v.shape``; the default is
        ``cheb_apply(matvecs[-1], v, c, lmaxes[-1])``. The ``bsr`` backend
        passes its union-kernel dispatch here.

    Returns:
      (eta,) + f.shape stacked outputs; for R = 1 exactly ``cheb_apply``.
    """
    n_shifts = len(matvecs)
    coeffs = _cast_coeffs(coeffs, f)
    if coeffs.ndim != n_shifts + 1:
        raise ValueError(
            f"joint coeffs must have ndim R+1 = {n_shifts + 1} "
            f"(eta leading), got shape {tuple(coeffs.shape)}"
        )
    if len(lmaxes) != n_shifts:
        raise ValueError(f"{len(lmaxes)} lmaxes for {n_shifts} shifts")
    if inner is None:
        def inner(v, c):
            return cheb_apply(matvecs[-1], v, c, lmaxes[-1])
    if n_shifts == 1:
        return inner(f, coeffs.contiguous())
    # eta just before the last axis: peeling the leading shift axes leaves
    # each innermost call a contiguous (eta, M_R+1) slice.
    ct = torch.movedim(coeffs, 0, -2).contiguous()

    def rec(v: torch.Tensor, c: torch.Tensor, level: int) -> torch.Tensor:
        if level == n_shifts - 1:
            return inner(v, c)
        mv = matvecs[level]
        alpha = _alpha(lmaxes[level], f)
        t0 = v
        t1 = (mv(v) - alpha * v) / alpha
        # per-axis half convention: the k = 0 Krylov vector enters with 1/2
        acc = 0.5 * rec(t0, c[0], level + 1) + rec(t1, c[1], level + 1)
        t_prev1, t_prev2 = t1, t0
        for k in range(2, c.shape[0]):
            t_k = (2.0 / alpha) * (mv(t_prev1) - alpha * t_prev1) - t_prev2
            acc = acc + rec(t_k, c[k], level + 1)
            t_prev1, t_prev2 = t_k, t_prev1
        return acc

    return rec(f, ct, 0)


def cheb_adjoint_apply_joint(
    matvecs: Sequence[Matvec],
    a: torch.Tensor,
    coeffs,
    lmaxes: Sequence[float],
) -> torch.Tensor:
    """Joint adjoint ``P* a`` for ``a`` shaped (eta,) + signal.shape.

    Commuting symmetric shifts make each joint term symmetric, so the
    adjoint runs the same per-axis recurrences with the eta blocks stacked
    along a trailing axis and contracts against the coefficients at the
    innermost level (``cheb_adjoint_apply``).
    """
    n_shifts = len(matvecs)
    coeffs = _cast_coeffs(coeffs, a)
    if coeffs.ndim != n_shifts + 1:
        raise ValueError(
            f"joint coeffs must have ndim R+1 = {n_shifts + 1}, "
            f"got shape {tuple(coeffs.shape)}"
        )
    if a.shape[0] != coeffs.shape[0]:
        raise ValueError(f"adjoint input has {a.shape[0]} blocks, coeffs {coeffs.shape[0]}")
    if n_shifts == 1:
        return cheb_adjoint_apply(matvecs[0], a, coeffs, lmaxes[0])
    ct = torch.movedim(coeffs, 0, -1)  # (M_1+1, ..., M_R+1, eta)
    v0 = torch.movedim(a, 0, -1)  # (N, [F,] eta)

    def rec(v: torch.Tensor, c: torch.Tensor, level: int) -> torch.Tensor:
        if level == n_shifts - 1:
            return cheb_adjoint_apply(
                matvecs[level], torch.movedim(v, -1, 0), torch.movedim(c, -1, 0),
                lmaxes[level],
            )
        mv = matvecs[level]
        alpha = _alpha(lmaxes[level], a)
        t0 = v
        t1 = (mv(v) - alpha * v) / alpha
        acc = 0.5 * rec(t0, c[0], level + 1) + rec(t1, c[1], level + 1)
        t_prev1, t_prev2 = t1, t0
        for k in range(2, c.shape[0]):
            t_k = (2.0 / alpha) * (mv(t_prev1) - alpha * t_prev1) - t_prev2
            acc = acc + rec(t_k, c[k], level + 1)
            t_prev1, t_prev2 = t_k, t_prev1
        return acc

    return rec(v0, ct, 0)


def product_coefficients(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Coefficients of the product of two Chebyshev series (half-first
    convention in and out), via ``T_k T_l = (T_{k+l} + T_{|k-l|}) / 2``."""
    a = np.asarray(c1, dtype=np.float64).copy()
    b = np.asarray(c2, dtype=np.float64).copy()
    a[0] *= 0.5
    b[0] *= 0.5  # now p = sum_k a_k T_k with plain coefficients
    m = len(a) + len(b) - 1
    r = np.zeros(m)
    r += 0.5 * np.convolve(a, b)
    for k in range(len(a)):
        for l in range(len(b)):
            r[abs(k - l)] += 0.5 * a[k] * b[l]
    r[0] *= 2.0  # back to half-first-coefficient convention
    return r


def gram_coefficients(coeffs: np.ndarray) -> np.ndarray:
    """Degree-2M coefficients ``d_k`` of ``Phi~* Phi~`` (paper Sec. IV-C):
    ``d = sum_j product_coefficients(c_j, c_j)``."""
    c = np.atleast_2d(np.asarray(coeffs, dtype=np.float64))
    out = np.zeros(2 * (c.shape[1] - 1) + 1)
    for j in range(c.shape[0]):
        out += product_coefficients(c[j], c[j])
    return out


def _halve_axis0(c: np.ndarray, axes: Sequence[int]) -> np.ndarray:
    """Half-convention -> plain coefficients along the given axes."""
    c = np.array(c, dtype=np.float64)
    for ax in axes:
        sl = [slice(None)] * c.ndim
        sl[ax] = 0
        c[tuple(sl)] *= 0.5
    return c


def joint_product_coefficients(c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Joint-tensor analog of :func:`product_coefficients`: the
    (2M_1+1, ..., 2M_R+1) coefficients of the product of two
    (M_1+1, ..., M_R+1) series (half convention per axis), applying
    ``T_k T_l = (T_{k+l} + T_{|k-l|}) / 2`` on every axis."""
    a = _halve_axis0(np.atleast_1d(c1), range(np.ndim(c1)))
    b = _halve_axis0(np.atleast_1d(c2), range(np.ndim(c2)))
    n_shifts = a.ndim
    if b.ndim != n_shifts:
        raise ValueError(f"rank mismatch: {a.shape} vs {b.shape}")
    # Outer tensor over (k_1..k_R, l_1..l_R), then fold each (k_r, l_r)
    # pair into one m_r axis with the 1-D product identity.
    t = np.multiply.outer(a, b)
    for r in range(n_shifts):
        # After r folds, t has axes (m_1..m_r, k_{r+1}..k_R, l_{r+1}..l_R);
        # the current k axis is at r, the matching l axis at n_shifts.
        t = np.moveaxis(t, (r, n_shifts), (0, 1))
        k_dim, l_dim = t.shape[0], t.shape[1]
        folded = np.zeros((k_dim + l_dim - 1,) + t.shape[2:])
        for k in range(k_dim):
            for l in range(l_dim):
                folded[k + l] += 0.5 * t[k, l]
                folded[abs(k - l)] += 0.5 * t[k, l]
        t = np.moveaxis(folded, 0, r)
    # plain -> half convention on every axis
    out = t
    for ax in range(n_shifts):
        sl = [slice(None)] * out.ndim
        sl[ax] = 0
        out[tuple(sl)] *= 2.0
    return out


def joint_gram_coefficients(coeffs: np.ndarray) -> np.ndarray:
    """Joint coefficients of ``P* P = sum_j p_j(S_1..S_R)^2``: (eta,
    M_1+1, ..., M_R+1) -> (2M_1+1, ..., 2M_R+1); for R = 1 exactly
    :func:`gram_coefficients`."""
    c = np.asarray(coeffs, dtype=np.float64)
    out = np.zeros(tuple(2 * (m - 1) + 1 for m in c.shape[1:]))
    for j in range(c.shape[0]):
        out += joint_product_coefficients(c[j], c[j])
    return out


def separable_joint_coefficients(factors: Sequence[np.ndarray]) -> np.ndarray:
    """Joint tensor of a separable multiplier ``g(x_1..x_R) = prod g_r(x_r)``.

    Each factor is the (eta, M_r+1) or (M_r+1,) half-convention series of
    ``g_r``; their per-j outer product is the half-convention joint tensor
    (eta, M_1+1, ..., M_R+1). Multi-multiplier factors must share eta.
    """
    mats = [np.atleast_2d(np.asarray(f, dtype=np.float64)) for f in factors]
    eta = max(m.shape[0] for m in mats)
    for m in mats:
        if m.shape[0] not in (1, eta):
            raise ValueError("factors must share eta (or be single)")
    out = None
    for m in mats:
        m = np.broadcast_to(m, (eta,) + m.shape[1:])
        if out is None:
            out = m
        else:
            out = np.einsum("j...,jk->j...k", out, m)
    return out


def inverse_coefficients(
    h_coeffs: np.ndarray,
    lmax: float | Sequence[float],
    order: int | Sequence[int],
    *,
    reg: float = 0.0,
    quad_points: int | None = None,
) -> np.ndarray:
    """Low-order Chebyshev fit of ``q(lambda) ~= 1 / (h(lambda) + reg)``.

    The inverse-filtering core (arXiv:2504.14341): ``h`` is given by its
    own Chebyshev series (typically a filter's ``gram_coeffs``) and the
    returned order-K series ``q`` approximates its regularized reciprocal
    on the spectral domain, by Chebyshev--Gauss quadrature. Used as a
    polynomial preconditioner for CG and as the fixed-point iteration
    ``x <- x + q(L) (b - (h(L) + reg) x)``, whose linear rate is
    :func:`inverse_fixed_point_rate`.

    Single-shift: ``h_coeffs`` is (2M+1,), ``lmax``/``order`` scalars, and
    the result is a (K+1,) series. Sequences of lmaxes and orders give the
    per-axis tensor quadrature of a joint series, as in the reference.
    ``h + reg`` must be positive on the whole domain; a nonpositive
    minimum raises ``ValueError``.
    """
    h = np.asarray(h_coeffs, dtype=np.float64)
    scalar = np.isscalar(lmax) or np.ndim(lmax) == 0
    lmaxes = [float(lmax)] if scalar else [float(v) for v in lmax]
    orders = [int(order)] if scalar else [int(v) for v in order]
    if h.ndim != len(lmaxes) or len(orders) != len(lmaxes):
        raise ValueError(
            f"h ndim {h.ndim} vs {len(lmaxes)} lmaxes / {len(orders)} orders"
        )
    ps = [quad_points or max(k + 1, 64) * 4 for k in orders]
    thetas = [np.pi * (np.arange(p) + 0.5) / p for p in ps]
    xs = [(lm / 2.0) * (np.cos(th) + 1.0) for lm, th in zip(lmaxes, thetas)]
    hv = cheb_eval_joint(h[None], xs, lmaxes)[0]
    denom = hv + reg
    if float(denom.min()) <= 0.0:
        raise ValueError(
            f"h + reg not positive on the domain (min {float(denom.min()):.3e});"
            " raise reg= or check the series"
        )
    c = 1.0 / denom
    for r in range(len(lmaxes)):
        basis = np.cos(np.outer(np.arange(orders[r] + 1), thetas[r]))
        c = np.tensordot(c, basis, axes=[[0], [1]]) * (2.0 / ps[r])
    return c if not scalar else np.asarray(c)


def inverse_fixed_point_rate(
    q_coeffs: np.ndarray,
    h_coeffs: np.ndarray,
    lmax: float | Sequence[float],
    *,
    reg: float = 0.0,
    grid: int = 2048,
) -> float:
    """Sup-norm contraction factor ``max |1 - q(x)(h(x) + reg)|``.

    The fixed-point iteration ``x <- x + q(L) r`` converges linearly at
    this rate; values >= 1 mean the fit order is too low for ``h`` and
    ``reg``.
    """
    q = np.asarray(q_coeffs, dtype=np.float64)
    h = np.asarray(h_coeffs, dtype=np.float64)
    scalar = np.isscalar(lmax) or np.ndim(lmax) == 0
    lmaxes = [float(lmax)] if scalar else [float(v) for v in lmax]
    n_pts = max(64, int(round(grid ** (1.0 / len(lmaxes)))))
    xs = [np.linspace(0.0, lm, n_pts) for lm in lmaxes]
    qv = cheb_eval_joint(q[None], xs, lmaxes)[0]
    hv = cheb_eval_joint(h[None], xs, lmaxes)[0]
    return float(np.max(np.abs(1.0 - qv * (hv + reg))))
