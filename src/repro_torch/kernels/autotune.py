"""Tiling selection for the Chebyshev kernels on Hopper.

Mirrors ``repro/kernels/autotune.py``, rederived for the port's fused
kernel (``csrc/cheb_bsr.cu``). The reference budgets TPU VMEM (12 MiB) and
MXU-aligned tiles; neither binds the H100. What the port's fused kernel
keeps on chip is different:

* each resident thread owns ``UNION_ROWS`` = 8 rows of one strip (a
  strip is the B rows of one block row in one signal column: all of it at
  B = 8, half at B = 16) for a whole pass, and keeps their 8 x 64/B
  accumulators in registers; the kernel is compiled with
  ``__launch_bounds__(256, 2)``, so an SM holds
  ``UNION_THREADS_PER_SM`` = 512 of its threads (up to 128 registers each
  of the SM's 65,536). All blocks must be resident at once for the
  grid-wide barrier between orders, so one pass holds at most
  ``sm_count * 512`` threads, N / 8 of them per signal column: 67,584 on
  an H100 SXM (132 SMs);
* ``B`` is a template parameter of the kernel, built for
  ``UNION_BLOCKS`` = (8, 16) only;
* the T_{k-1}/T_{k-2} ping/pong buffers live in global scratch, and a
  pass's Krylov state plus the tiles should stay in the 50 MB L2, so the
  bytes a pass touches are kept under ``L2_BUDGET_BYTES`` (40 MB).

The decisions:

* ``fuse`` is True exactly when the signal is float32, ``B`` is in
  ``UNION_BLOCKS`` and one whole signal column (N / 8 threads) fits in
  one resident pass, ``N / 8 <= sm_count * UNION_THREADS_PER_SM``.
  Otherwise callers chain the stepwise kernel.
* ``f_tile`` is, when fused, the signal columns per resident pass: the
  largest width that fits the pass and the L2 budget, rounded down to a
  multiple of 32 when it is at least 32 and does not hold all of F, so
  every warp of a pass lies in one strip and every pass starts on a
  128-byte boundary; when not fused, the step kernel's column slab,
  ``min(F, 128)``.

The fused adjoint kernel (``cheb_adjoint_union_cuda``) has the union
kernel's threads, registers bound and block sizes, so the same rule
decides it; ``adjoint=True`` adds its own working set, the eta input
columns it reads at every order, to the L2 budget of a pass.

``_F_TILE_TABLE`` (measured-good tiles keyed by block size and dtype) is
empty: it is filled only from H100 measurements.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "Tiling",
    "select_tiling",
    "union_resident_threads",
    "union_eta_group",
    "union_grid_barriers",
    "device_sm_count",
    "union_pass_bytes",
    "H100_SMS",
    "L2_BUDGET_BYTES",
]

H100_SMS = 132  # H100 SXM (NVIDIA data sheet)
UNION_THREADS_PER_SM = 512  # 2 blocks x 256 threads, __launch_bounds__(256, 2)
UNION_ROWS = 8  # rows of a strip one thread owns (UNION_ROWS in csrc/cheb_bsr.cu)
UNION_BLOCKS = (8, 16)  # block sizes the fused kernel is built for
UNION_ACC = 64  # accumulators a thread keeps (UNION_ACC in csrc/cheb_bsr.cu)
WARP = 32
L2_BUDGET_BYTES = 40 * 1024 * 1024  # of the H100's 50 MB L2
STEP_F_TILE = 128

_F_TILE_TABLE: dict[tuple[int, str], tuple[int, ...]] = {}


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Resolved kernel launch configuration.

    Attributes:
      f_tile: signal columns per fused pass (fused) or per step slab.
      fuse: True when the fused union kernel can hold the apply.
      pass_bytes: bytes one fused pass touches at this tiling.
    """

    f_tile: int
    fuse: bool
    pass_bytes: int


def device_sm_count(device: torch.device) -> int:
    """SMs of ``device`` when it is a CUDA device, else the H100's."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def union_resident_threads(sm_count: int = H100_SMS) -> int:
    """Threads (8 rows of one signal column each) one resident pass holds."""
    return sm_count * UNION_THREADS_PER_SM


def union_eta_group(block: int) -> int:
    """Multipliers the fused kernel accumulates per walk over the passes."""
    return UNION_ACC // block


def union_grid_barriers(f: int, f_tile: int, eta: int, order: int, block: int) -> int:
    """Grid barriers in one fused launch: ``order - 1`` per pass and
    multiplier group, and one before each group after the first."""
    groups = -(-eta // union_eta_group(block))
    passes = -(-f // min(f_tile, f))
    return groups * passes * (order - 1) + groups - 1


def union_pass_bytes(
    n: int,
    f_tile: int,
    n_rows: int,
    k_max: int,
    block: int,
    *,
    krylov_dtype: torch.dtype = torch.float32,
    inputs: int = 1,
) -> int:
    """Bytes one fused pass touches each order: the tiles and columns,
    the ``inputs`` input columns of each of the pass's signal columns (1
    for the apply, eta for the adjoint), and its two Krylov buffers. The
    eta accumulators are in registers and are not counted."""
    tiles = n_rows * k_max * (block * block * 4 + 4)
    signal = inputs * n * f_tile * 4
    krylov = 2 * n * f_tile * krylov_dtype.itemsize
    return tiles + signal + krylov


def select_tiling(
    n: int,
    f: int,
    eta: int,
    n_rows: int,
    k_max: int,
    block: int,
    dtype: torch.dtype = torch.float32,
    *,
    krylov_dtype: torch.dtype = torch.float32,
    sm_count: int = H100_SMS,
    adjoint: bool = False,
) -> Tiling:
    """Pick ``(f_tile, fuse)`` for a Chebyshev union apply or its adjoint.

    Parameters
    ----------
    n, f : int
        Padded signal shape (N, F).
    eta : int
        Multipliers in the union (the kernel loops over groups of
        ``union_eta_group(block)``; it does not change the decision). The
        adjoint reads eta input columns per signal column at every order.
    n_rows, k_max, block : int
        Block-ELL operand shape.
    dtype : torch.dtype
        Signal dtype; the fused kernel takes float32 signals only.
    krylov_dtype : torch.dtype
        Krylov-buffer precision of the fused kernel.
    sm_count : int
        SMs of the card (``multi_processor_count``).
    adjoint : bool
        Tile the fused adjoint kernel instead of the union apply.
    """
    capacity = union_resident_threads(sm_count)
    per_column = n // UNION_ROWS  # threads one signal column takes
    fuse = dtype == torch.float32 and block in UNION_BLOCKS and per_column <= capacity
    inputs = eta if adjoint else 1

    def pass_bytes(width):
        return union_pass_bytes(n, width, n_rows, k_max, block, krylov_dtype=krylov_dtype,
                                inputs=inputs)

    if not fuse:
        return Tiling(f_tile=min(f, STEP_F_TILE), fuse=False, pass_bytes=pass_bytes(1))
    fixed = pass_bytes(0)
    column_bytes = pass_bytes(1) - fixed
    ft = max(1, min(capacity // per_column, (L2_BUDGET_BYTES - fixed) // column_bytes))
    if ft < f and ft >= WARP:
        ft -= ft % WARP
    ft = min(ft, f)
    table = _F_TILE_TABLE.get((block, str(dtype).removeprefix("torch.")), ())
    ft = max((c for c in table if c <= ft), default=ft)
    return Tiling(f_tile=ft, fuse=True, pass_bytes=pass_bytes(ft))
