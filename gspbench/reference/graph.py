"""The sensor graph and its Laplacian, rebuilt from the seeded positions.

Paper eq. 1: ``w(i, j) = exp(-d(i, j)^2 / (2 sigma^2))`` when
``d(i, j) <= kappa``, else 0; ``L = D - W`` (Sec. II). The edge set is
decided on the float32 positions the cell is given, with the same
expression for the squared distance, so a pair at the threshold falls on
the same side as in any float32 build; the weights, degrees and the
Anderson-Morley bound ``lambda_max <= max_{i~j} (d_i + d_j)`` are float64.
The Laplacian is held as a sparse CSR matrix and built in blocks of rows,
so no (N, N) array is ever formed.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

__all__ = ["Laplacian", "sensor_laplacian", "round_tf32", "PRECISIONS"]

PRECISIONS = ("float64", "tf32")
_TF32_DROP = 13  # float32 keeps 23 mantissa bits, TF32 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 rounded to TF32's 10 mantissa bits (to nearest,
    ties to even): what a TF32 matrix product does to its operands."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    half = (1 << (_TF32_DROP - 1)) - 1
    bits = (bits + half + ((bits >> _TF32_DROP) & 1)) & ~((1 << _TF32_DROP) - 1)
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Laplacian:
    """``L = D - W`` of a sensor graph.

    Attributes:
      rows, cols: (2|E|,) int64 endpoints of each directed edge (i != j).
      weights: (2|E|,) float64 ``w(i, j)``.
      degree: (N,) float64.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    weights: torch.Tensor
    degree: torch.Tensor

    @property
    def n(self) -> int:
        return self.degree.shape[0]

    @property
    def n_edges(self) -> int:
        """|E|, undirected."""
        return self.rows.shape[0] // 2

    @property
    def nnz(self) -> int:
        """Nonzeros of L as the benchmark counts them: 2|E| + N."""
        return 2 * self.n_edges + self.n

    def lmax_bound(self) -> float:
        """Anderson-Morley bound, the rule the filter's spectrum is shifted by."""
        if self.rows.numel() == 0:
            return 0.0
        return float(torch.max(self.degree[self.rows] + self.degree[self.cols]))

    def _csr(self, dtype: torch.dtype) -> torch.Tensor:
        n = self.n
        diag = torch.arange(n, device=self.degree.device)
        idx = torch.stack([torch.cat([self.rows, diag]), torch.cat([self.cols, diag])])
        vals = torch.cat([-self.weights, self.degree]).to(dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # sparse CSR is "beta"
            coo = torch.sparse_coo_tensor(idx, vals, (n, n), check_invariants=True).coalesce()
            return coo.to_sparse_csr()

    def operator(self, precision: str = "float64"):
        """``v -> L v`` for (N, K) tensors: float64, or float32 with both
        operands of the product rounded to TF32 (the control)."""
        if precision == "float64":
            csr = self._csr(torch.float64)
            return lambda v: csr @ v.to(torch.float64)
        if precision == "tf32":
            csr = self._csr(torch.float32)
            csr = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                          round_tf32(csr.values()), csr.shape,
                                          check_invariants=True)
            return lambda v: csr @ round_tf32(v)
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def sensor_laplacian(
    coords: torch.Tensor, sigma: float, kappa: float, *, rows_per_block: int = 2048
) -> Laplacian:
    """The eq. 1 Laplacian of sensors at ``coords`` ((N, 2) float32)."""
    pos = coords.to(torch.float32)
    n = pos.shape[0]
    rows, cols = [], []
    for start in range(0, n, rows_per_block):
        block = pos[start:start + rows_per_block]
        d2 = torch.sum((block[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
        near = d2 <= kappa**2
        local = torch.arange(block.shape[0], device=pos.device)
        near[local, local + start] = False
        r, c = near.nonzero(as_tuple=True)
        rows.append(r + start)
        cols.append(c)
    rows_t, cols_t = torch.cat(rows), torch.cat(cols)
    p64 = pos.to(torch.float64)
    d2_64 = torch.sum((p64[rows_t] - p64[cols_t]) ** 2, dim=-1)
    w = torch.exp(-d2_64 / (2.0 * sigma**2))
    degree = torch.zeros(n, dtype=torch.float64, device=pos.device).index_add_(0, rows_t, w)
    return Laplacian(rows=rows_t, cols=cols_t, weights=w, degree=degree)
