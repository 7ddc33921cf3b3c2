"""Shifted-Chebyshev approximation of graph Fourier multipliers.

Mirrors ``repro/core/chebyshev.py`` (single-shift subset; the ``*_joint``
and inverse functions come with the multi-shift port):

* eq. (8)  — Chebyshev coefficients ``c_{j,k}`` by Chebyshev--Gauss
  quadrature (host numpy float64, identical to the reference),
* eq. (9)  — the recurrence
  ``Tbar_k(L) f = (2/alpha)(L - alpha I) Tbar_{k-1}(L) f - Tbar_{k-2}(L) f``
  evaluated with matvecs against ``L`` (a Python loop where the reference
  has ``lax.scan``),
* eq. (11) — the union combine over one shared Krylov sequence,
* Sec. IV-C — the product identity behind the degree-2M Gram series.

Coefficients are float64 numpy; every apply casts them explicitly to the
signal's dtype and device, as the reference does, so a float32 signal is
never promoted to float64.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "cheb_coefficients",
    "cheb_eval",
    "cheb_apply",
    "cheb_apply_krylov",
    "cheb_apply_dense",
    "cheb_adjoint_apply",
    "product_coefficients",
    "gram_coefficients",
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


def _cast_coeffs(coeffs, like: torch.Tensor) -> torch.Tensor:
    """Coefficients as a tensor of ``like``'s dtype and device (explicit
    cast: float64 numpy must not promote a float32 recurrence)."""
    if isinstance(coeffs, torch.Tensor):
        return coeffs.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(coeffs), device=like.device).to(like.dtype)


def _alpha(lmax, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(float(lmax), dtype=like.dtype, device=like.device) / 2.0


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
