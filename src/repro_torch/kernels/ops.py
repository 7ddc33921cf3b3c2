"""Public wrappers around the Block-ELL Chebyshev kernels.

Mirrors ``repro/kernels/ops.py``. ``cheb_apply_bsr_fused`` runs the whole
union apply (eq. 9 + eq. 11) in one launch of the fused kernel;
``cheb_apply_bsr`` chains the step kernel once per order, with the eq. 11
combine in plain torch as the reference leaves it to XLA. The chain is the
fallback for shapes the fused kernel cannot hold and the fused kernel's
oracle. Both follow the device of ``f``: CUDA tensors run the CUDA
kernels, CPU tensors their plain versions.

Callers normally go through ``repro_torch.filters.GraphFilter`` with
``backend="bsr"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import chebyshev
from repro_torch.kernels.cheb_bsr import cheb_step_cuda, cheb_union_cuda
from repro_torch.kernels.ref import BlockEll, bsr_from_dense

__all__ = ["BlockEll", "bsr_from_dense", "cheb_apply_bsr", "cheb_apply_bsr_fused"]


def cheb_apply_bsr_fused(
    blocks: torch.Tensor,
    cols: torch.Tensor,
    f: torch.Tensor,
    coeffs,
    lmax: float,
    *,
    f_tile: int | None = None,
    krylov_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``Phi~ f`` via the fused union kernel (one launch).

    Parameters
    ----------
    blocks, cols : torch.Tensor
        Block-ELL Laplacian (see ``kernels/ref.py``).
    f : torch.Tensor
        (N, F) float32 signal batch.
    coeffs : array-like or torch.Tensor
        (eta, M+1) Chebyshev coefficients (passed to the kernel as a
        float32 device array; a tensor on ``f``'s device is used as is).
    lmax : float
        Spectrum bound.
    f_tile : int, optional
        Columns per resident pass; default from ``select_tiling``.
    krylov_dtype : torch.dtype, optional
        Ping/pong buffer precision, default float32.

    Returns
    -------
    torch.Tensor
        (eta, N, F).
    """
    return cheb_union_cuda(
        blocks, cols, f, coeffs=coeffs, lmax=float(lmax), f_tile=f_tile,
        krylov_dtype=krylov_dtype or torch.float32,
    )


def cheb_apply_bsr(
    blocks: torch.Tensor,
    cols: torch.Tensor,
    f: torch.Tensor,
    coeffs,
    lmax: float,
    *,
    f_tile: int | None = None,
    krylov_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``Phi~ f`` with the stepwise chain (one step launch per order).

    Args:
      blocks/cols: Block-ELL Laplacian.
      f: (N, F) signal batch.
      coeffs: (eta, M+1) Chebyshev coefficients (host array or tensor).
      lmax: spectrum bound.
      f_tile: the step kernel's column slab (default ``min(F, 128)``).
      krylov_dtype: dtype the carried ``T_{k-1}``/``T_{k-2}`` round-trip
        through between steps (default ``f.dtype``); each step still
        combines in f32 and the accumulator stays in ``f.dtype``.

    Returns: (eta, N, F).
    """
    if isinstance(coeffs, torch.Tensor):
        coeffs = torch.atleast_2d(coeffs)
    else:
        coeffs = np.atleast_2d(np.asarray(coeffs))
    coeffs = chebyshev._cast_coeffs(coeffs, f)
    alpha = float(lmax) / 2.0

    def step(t1, t2, first=False):
        return cheb_step_cuda(blocks, cols, t1, t2, alpha=alpha, first=first, f_tile=f_tile)

    t0 = f
    t1 = step(f, f, first=True)
    acc = 0.5 * coeffs[:, 0, None, None] * t0[None] + coeffs[:, 1, None, None] * t1[None]
    kd = krylov_dtype or f.dtype
    t_prev1, t_prev2 = t1.to(kd), t0.to(kd)
    for k in range(2, coeffs.shape[1]):
        t_k = step(t_prev1, t_prev2)
        acc = acc + coeffs[:, k, None, None] * t_k.to(acc.dtype)[None]
        t_prev1, t_prev2 = t_k, t_prev1
    return acc
