"""Plain PyTorch versions of the Block-ELL Chebyshev kernels.

Mirrors ``repro/kernels/ref.py`` and adds ``cheb_union_ref`` and
``cheb_adjoint_union_ref``, the plain versions of the fused union kernel
and of its adjoint. These functions are the kernels' oracles: the CPU
tests run them, the kernel wrappers use them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. They
operate on the same Block-ELL operands as the kernels, padding slots
included.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "BlockEll",
    "bsr_from_dense",
    "bsr_to_dense",
    "bsr_matvec_ref",
    "cheb_step_ref",
    "cheb_apply_bsr_ref",
    "cheb_union_ref",
    "cheb_adjoint_union_ref",
    "step_constants",
]


@dataclasses.dataclass(frozen=True)
class BlockEll:
    """Block-ELL sparse matrix: a fixed number of tiles per block-row.

    Padding slots have ``cols == 0`` and all-zero tiles. Construction
    checks shapes and that every column lies in ``[0, n_block_rows)``, so
    the kernels can index with ``cols`` unchecked.

    Attributes:
      blocks: (n_rows, k_max, block, block) dense tiles.
      cols:   (n_rows, k_max) int32 block-column indices.
    """

    blocks: torch.Tensor
    cols: torch.Tensor

    def __post_init__(self):
        nb, k_max, b, b2 = self.blocks.shape
        if b != b2:
            raise ValueError(f"tiles must be square, got {tuple(self.blocks.shape)}")
        if tuple(self.cols.shape) != (nb, k_max) or self.cols.dtype != torch.int32:
            raise ValueError(
                f"cols must be int32 of shape {(nb, k_max)}, got "
                f"{self.cols.dtype} {tuple(self.cols.shape)}"
            )
        if self.cols.device != self.blocks.device:
            raise ValueError("blocks and cols must share a device")
        lo, hi = (int(v) for v in torch.aminmax(self.cols))
        if lo < 0 or hi >= nb:
            raise ValueError(f"block columns must lie in [0, {nb}), got [{lo}, {hi}]")

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def k_max(self) -> int:
        return self.blocks.shape[1]

    @property
    def block_size(self) -> int:
        return self.blocks.shape[-1]

    @property
    def n(self) -> int:
        return self.n_block_rows * self.block_size

    @property
    def nnz_blocks(self) -> int:
        """True (non-padding) tile count."""
        return int(torch.count_nonzero(torch.any(torch.any(self.blocks != 0, -1), -1)))

    @property
    def density(self) -> float:
        return self.nnz_blocks / (self.n_block_rows**2)


def bsr_from_dense(
    mat: torch.Tensor, block_size: int, dtype: torch.dtype = torch.float32
) -> BlockEll:
    """Convert a dense (N, N) matrix to Block-ELL on ``mat``'s device.

    N is zero-padded up to a multiple of ``block_size``. ``k_max`` is the
    largest number of nonzero tiles in any block-row (>= 1). Each row's
    tiles are stored in ascending column order, padding after them, as in
    the reference.
    """
    n = mat.shape[0]
    n_pad = ((n + block_size - 1) // block_size) * block_size
    full = torch.zeros((n_pad, n_pad), dtype=mat.dtype, device=mat.device)
    full[:n, :n] = mat
    nb = n_pad // block_size
    tiles = full.reshape(nb, block_size, nb, block_size).permute(0, 2, 1, 3)
    nz = torch.any(torch.any(tiles != 0, -1), -1)  # (nb, nb)
    counts = nz.sum(dim=1)
    k_max = max(int(counts.max()), 1)
    # Stable sort of "is zero" puts each row's nonzero columns first, in
    # ascending order.
    order = torch.sort((~nz).to(torch.int8), dim=1, stable=True).indices[:, :k_max]
    valid = torch.arange(k_max, device=mat.device)[None, :] < counts[:, None]
    cols = torch.where(valid, order, torch.zeros_like(order)).to(torch.int32)
    rows = torch.arange(nb, device=mat.device)[:, None]
    blocks = tiles[rows, order] * valid[:, :, None, None].to(mat.dtype)
    return BlockEll(blocks.to(dtype).contiguous(), cols.contiguous())


def bsr_to_dense(bell: BlockEll) -> torch.Tensor:
    """Densify (oracle / debugging)."""
    nb, k_max, b, _ = bell.blocks.shape
    out = torch.zeros((nb, nb, b, b), dtype=bell.blocks.dtype, device=bell.blocks.device)
    rows = torch.arange(nb, device=bell.blocks.device).repeat_interleave(k_max)
    out.index_put_(
        (rows, bell.cols.reshape(-1).long()),
        bell.blocks.reshape(nb * k_max, b, b),
        accumulate=True,
    )
    return out.permute(0, 2, 1, 3).reshape(nb * b, nb * b)


def _lx_f32(
    blocks: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``L @ x`` from Block-ELL operands, products and sums in float32
    (or ``dtype``)."""
    nb, _, b, _ = blocks.shape
    xb = x.reshape(nb, b, -1).to(dtype)
    gathered = xb[cols.long()]  # (nb, k_max, b, F)
    out = torch.einsum("rkij,rkjf->rif", blocks.to(dtype), gathered)
    return out.reshape(x.shape[0], -1)


def bsr_matvec_ref(bell: BlockEll, x: torch.Tensor) -> torch.Tensor:
    """Oracle ``L @ x`` from Block-ELL operands. x: (N, F)."""
    return _lx_f32(bell.blocks, bell.cols, x).reshape(x.shape).to(x.dtype)


def step_constants(alpha: float, first: bool) -> tuple[float, float, float]:
    """``(ca, cb, cc)`` of one step ``out = ca L t1 + cb t1 + cc t2``."""
    return (1.0 / alpha, -1.0, 0.0) if first else (2.0 / alpha, -2.0, -1.0)


def cheb_step_ref(
    blocks: torch.Tensor,
    cols: torch.Tensor,
    t1: torch.Tensor,
    t2: torch.Tensor,
    alpha: float,
    *,
    first: bool = False,
) -> torch.Tensor:
    """Plain version of one fused Chebyshev recurrence step (eq. 9).

    first=False: ``T_k = (2/a) L t1 - 2 t1 - t2``
    first=True:  ``T_1 = (1/a) L t1 - t1``  (t2 ignored)

    f32 products, sums and combine, one final cast to ``t1.dtype``.
    """
    lv = _lx_f32(blocks, cols, t1)
    t1f = t1.to(torch.float32)
    if first:
        out = lv / alpha - t1f
    else:
        out = (2.0 / alpha) * lv - 2.0 * t1f - t2.to(torch.float32)
    return out.to(t1.dtype)


def cheb_apply_bsr_ref(bell: BlockEll, f: torch.Tensor, coeffs, lmax: float):
    """Oracle for the full union apply on Block-ELL operands."""
    from repro_torch.core import chebyshev

    return chebyshev.cheb_apply(lambda v: bsr_matvec_ref(bell, v), f, coeffs, lmax)


def cheb_union_ref(
    blocks: torch.Tensor,
    cols: torch.Tensor,
    f: torch.Tensor,
    coeffs,
    lmax: float,
    *,
    krylov_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of the fused union kernel: eq. 9 + eq. 11.

    ``T_0 = f``, ``T_1 = L f / a - f``, ``T_k = (2/a) L T_{k-1} - 2 T_{k-1}
    - T_{k-2}``. Every step computes in f32; only the stored ping/pong
    buffers round to ``krylov_dtype`` (T_0 is read from ``f`` itself), and
    the f32 accumulators pick up the unrounded ``T_k``.

    Returns: (eta, N, F) in ``f.dtype``.
    """
    c = np.atleast_2d(np.asarray(coeffs, dtype=np.float64)).tolist()
    eta, order = len(c), len(c[0]) - 1
    if order < 1:
        raise ValueError("need at least order 1 (two coefficients)")
    f32 = torch.float32
    alpha = lmax / 2.0
    t0 = f.to(f32)
    t1 = _lx_f32(blocks, cols, f) / alpha - t0
    acc = torch.stack([(c[j][0] * 0.5) * t0 + c[j][1] * t1 for j in range(eta)])
    ping, pong = t1.to(krylov_dtype), None
    src0 = f  # T_0 stays the read-only input
    for k in range(2, order + 1):
        src1 = ping if k % 2 == 0 else pong
        t_new = (2.0 / alpha) * _lx_f32(blocks, cols, src1) - 2.0 * src1.to(f32) - src0.to(f32)
        stored = t_new.to(krylov_dtype)
        if k % 2 == 0:
            pong = stored
        else:
            ping = stored
        src0 = src1
        for j in range(eta):
            acc[j] += c[j][k] * t_new
    return acc.to(f.dtype)


def cheb_adjoint_union_ref(
    blocks: torch.Tensor,
    cols: torch.Tensor,
    a: torch.Tensor,
    coeffs,
    lmax: float,
) -> torch.Tensor:
    """Plain version of the fused adjoint kernel: eq. 13 by Clenshaw's
    recurrence.

    ``L`` is symmetric, so ``Phi~* a = sum_k Tbar_k(L) z_k`` with
    ``z_k = sum_j c_{j,k} a_j`` (``c_{j,0}`` halved). With ``Lt = L / a -
    I``: ``b_{M+1} = b_{M+2} = 0``, ``b_k = z_k + 2 Lt b_{k+1} - b_{k+2}``
    for k = M .. 1, and the result ``z_0 + Lt b_1 - b_2``. Every step
    computes in f32, with the coefficients rounded to f32 as the kernel
    reads them; a float64 ``a`` computes in float64 throughout.

    Args:
      a: (eta, N) or (eta, N, F) stacked coefficient signals.
      coeffs: (eta, M+1), M >= 1: a host array or a tensor.

    Returns: (N,) or (N, F) in ``a.dtype``.
    """
    wd = torch.float64 if a.dtype == torch.float64 else torch.float32
    if isinstance(coeffs, torch.Tensor):
        c = torch.atleast_2d(coeffs).to(device=a.device, dtype=wd)
    else:
        c = torch.as_tensor(np.atleast_2d(np.asarray(coeffs, dtype=np.float64)), dtype=wd,
                            device=a.device)
    eta, order = c.shape[0], c.shape[1] - 1
    if order < 1:
        raise ValueError("need at least order 1 (two coefficients)")
    if a.shape[0] != eta:
        raise ValueError(f"adjoint input has {a.shape[0]} blocks, coeffs {eta}")
    c = torch.cat([0.5 * c[:, :1], c[:, 1:]], dim=1)
    a3 = (a[:, :, None] if a.dim() == 2 else a).to(wd)
    alpha = lmax / 2.0

    def z(k):
        return torch.tensordot(c[:, k], a3, dims=1)

    b1, b2 = z(order), torch.zeros_like(a3[0])
    for k in range(order - 1, 0, -1):
        b1, b2 = z(k) + (2.0 / alpha) * _lx_f32(blocks, cols, b1, wd) - 2.0 * b1 - b2, b1
    out = z(0) + _lx_f32(blocks, cols, b1, wd) / alpha - b1 - b2
    return (out[:, 0] if a.dim() == 2 else out).to(a.dtype)
