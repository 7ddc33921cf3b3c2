"""The work a call needs, from the cell's shapes and the graph's nonzeros.

Counts never look at tiles, padding or which kernels ran, so a later
kernel that skips padding or fuses launches is held to the same yardstick.
``nnz`` is the Laplacian's nonzero count ``2|E| + N``.

* A union apply ``Phi f`` of an (N, F) panel at order M with eta kernels:
  M * nnz * F multiply-adds for the recurrence and eta * (M + 1) * N * F
  for the combine, two operations each; it reads L (a float32 value and an
  int32 column index per nonzero, N + 1 int32 row offsets) and the signal
  once and writes the eta outputs once.
* The adjoint ``Phi* a`` of an (eta, N, F) stack: the recurrence runs on
  eta * F columns (M * nnz * eta * F multiply-adds) and the combine is
  eta * (M + 1) * N * F; it reads L and the stack and writes one (N, F).

The bound of a call is the larger of its operations at the float32 peak
(no tensor cores) and its bytes at the HBM rate.
"""

from __future__ import annotations

__all__ = [
    "PEAK_F32_FLOPS",
    "PEAK_HBM_BYTES",
    "apply_work",
    "adjoint_work",
    "bound_seconds",
]

# NVIDIA H100 SXM data sheet, at its 700 W limit.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

_F32 = 4
_I32 = 4


def _laplacian_bytes(nnz: int, n: int) -> int:
    return nnz * (_F32 + _I32) + (n + 1) * _I32


def apply_work(nnz: int, n: int, f: int, eta: int, order: int) -> tuple[int, int]:
    """(operations, bytes) of one union apply."""
    flops = 2 * (order * nnz * f + eta * (order + 1) * n * f)
    nbytes = _laplacian_bytes(nnz, n) + n * f * _F32 + eta * n * f * _F32
    return flops, nbytes


def adjoint_work(nnz: int, n: int, f: int, eta: int, order: int) -> tuple[int, int]:
    """(operations, bytes) of one adjoint."""
    flops = 2 * (order * nnz * eta * f + eta * (order + 1) * n * f)
    nbytes = _laplacian_bytes(nnz, n) + eta * n * f * _F32 + n * f * _F32
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of a call, and which of ``operations`` and ``bytes``
    sets it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
