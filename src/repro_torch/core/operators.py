"""Exact eigendecomposition oracles for multiplier unions (paper eq. 5/6).

Mirrors ``repro/core/operators.py``: a numpy copy. These are the O(N^3)
computations the Chebyshev method avoids at scale, kept as test ground
truth. Inputs may be numpy arrays or tensors (tensors are copied to the
host).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["exact_union_apply", "exact_multiplier_matrix"]


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def exact_multiplier_matrix(
    laplacian_matrix,
    multipliers: Sequence[Callable[[np.ndarray], np.ndarray]],
) -> np.ndarray:
    """Oracle: stack of exact multiplier operators, shape (eta, N, N).

    ``Psi_j = chi g_j(Lambda) chi^T`` via full eigendecomposition (eq. 5).
    """
    lap = _host(laplacian_matrix)
    lam, chi = np.linalg.eigh(lap)
    lam = np.maximum(lam, 0.0)  # clip -eps from roundoff
    return np.stack([(chi * g(lam)) @ chi.T for g in multipliers])


def exact_union_apply(
    laplacian_matrix,
    multipliers: Sequence[Callable[[np.ndarray], np.ndarray]],
    f,
) -> np.ndarray:
    """Oracle ``Phi f`` (eq. 6): (eta,) + f.shape, float64."""
    mats = exact_multiplier_matrix(laplacian_matrix, multipliers)
    return np.stack([m @ _host(f) for m in mats])
