"""FISTA on the SGWT lasso (paper Sec. V-C, Beck and Teboulle 2009).

``argmin_a 1/2 ||y - Phi* a||^2 + sum_j mu_j ||a_j||_1`` with the scaling
band unpenalised (``mu_0 = 0``) and ``mu_j = mu`` on the wavelet bands,
step ``tau = 1 / ||Phi||^2`` (``cheb.operator_norm_bound``), started at
``a_0 = Phi y``:

    a_k     = S_{tau mu}(z_k + tau Phi (y - Phi* z_k))
    t_{k+1} = (1 + sqrt(1 + 4 t_k^2)) / 2
    z_{k+1} = a_k + ((t_k - 1) / t_{k+1}) (a_k - a_{k-1})

with ``z_1 = a_0`` and ``t_1 = 1``. Columns of a panel are independent
problems.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gspbench.reference import cheb

__all__ = ["fista"]


def fista(matvec, y: torch.Tensor, coeffs: np.ndarray, lmax: float, mu: float,
          n_iters: int) -> torch.Tensor:
    """The (eta, N, F) coefficients after ``n_iters`` iterations."""
    tau = 1.0 / cheb.operator_norm_bound(coeffs, lmax)
    eta = coeffs.shape[0]
    thresh = torch.full((eta, 1, 1), tau * mu, dtype=y.dtype, device=y.device)
    thresh[0] = 0.0

    def soft(v):
        return torch.sign(v) * torch.clamp(torch.abs(v) - thresh, min=0.0)

    a_prev = cheb.apply(matvec, y, coeffs, lmax)
    z, t = a_prev, 1.0
    for _ in range(n_iters):
        r = y - cheb.adjoint(matvec, z, coeffs, lmax)
        a = soft(z + tau * cheb.apply(matvec, r, coeffs, lmax))
        t_next = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        z = a + ((t - 1.0) / t_next) * (a - a_prev)
        a_prev, t = a, t_next
    return a_prev
