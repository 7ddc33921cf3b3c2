"""Tiling selection for the Chebyshev kernels on Hopper.

Mirrors ``repro/kernels/autotune.py``, rederived for the port's fused
kernel (``csrc/cheb_bsr.cu``). The reference budgets TPU VMEM (12 MiB) and
MXU-aligned tiles; neither binds the H100. What the port's fused kernel
keeps on chip is different:

* each resident thread owns ``UNION_ELEMS_PER_THREAD`` signal elements
  and keeps their eta accumulators in registers for the whole apply; the
  kernel is compiled with ``__launch_bounds__(256, 4)``, so an SM holds
  ``RESIDENT_THREADS_PER_SM`` = 1024 of its threads (64 registers each
  of the SM's 65,536). All blocks must be resident at once for the
  grid-wide barrier between orders, so one pass holds at most
  ``sm_count * 1024 * 2`` elements: 270,336 on an H100 SXM (132 SMs);
* the T_{k-1}/T_{k-2} ping/pong buffers live in global scratch, and a
  pass's Krylov state plus the tiles should stay in the 50 MB L2, so the
  bytes a pass touches are kept under ``L2_BUDGET_BYTES`` (40 MB).

The decisions:

* ``fuse`` is True exactly when the signal is float32 and one whole
  signal column (N elements) fits in one resident pass,
  ``N <= sm_count * RESIDENT_THREADS_PER_SM * UNION_ELEMS_PER_THREAD``.
  Otherwise callers chain the stepwise kernel.
* ``f_tile`` is, when fused, the signal columns per resident pass: the
  largest width that fits the pass and the L2 budget; when not fused, the
  step kernel's column slab, ``min(F, 128)``.

``_F_TILE_TABLE`` (measured-good tiles keyed by block size and dtype) is
empty: it is filled only from H100 measurements.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "Tiling",
    "select_tiling",
    "union_resident_elems",
    "device_sm_count",
    "union_pass_bytes",
    "H100_SMS",
    "L2_BUDGET_BYTES",
]

H100_SMS = 132  # H100 SXM (NVIDIA data sheet)
RESIDENT_THREADS_PER_SM = 1024  # 4 blocks x 256 threads, __launch_bounds__(256, 4)
UNION_ELEMS_PER_THREAD = 2  # UNION_EPT in csrc/cheb_bsr.cu
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


def union_resident_elems(sm_count: int = H100_SMS) -> int:
    """Signal elements one resident pass of the fused kernel holds."""
    return sm_count * RESIDENT_THREADS_PER_SM * UNION_ELEMS_PER_THREAD


def union_pass_bytes(
    n: int,
    f_tile: int,
    n_rows: int,
    k_max: int,
    block: int,
    *,
    krylov_dtype: torch.dtype = torch.float32,
) -> int:
    """Bytes one fused pass touches each order: the tiles and columns,
    the input columns of the pass, and its two Krylov buffers. The eta
    accumulators are in registers and are not counted."""
    tiles = n_rows * k_max * (block * block * 4 + 4)
    signal = n * f_tile * 4
    krylov = 2 * n * f_tile * torch.empty((), dtype=krylov_dtype).element_size()
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
) -> Tiling:
    """Pick ``(f_tile, fuse)`` for a Chebyshev union apply.

    Parameters
    ----------
    n, f : int
        Padded signal shape (N, F).
    eta : int
        Multipliers in the union (the kernel loops over groups of them;
        it does not change the decision).
    n_rows, k_max, block : int
        Block-ELL operand shape.
    dtype : torch.dtype
        Signal dtype; the fused kernel takes float32 signals only.
    krylov_dtype : torch.dtype
        Krylov-buffer precision of the fused kernel.
    sm_count : int
        SMs of the card (``multi_processor_count``).
    """
    del eta
    capacity = union_resident_elems(sm_count)
    fuse = dtype == torch.float32 and n <= capacity
    if not fuse:
        return Tiling(
            f_tile=min(f, STEP_F_TILE),
            fuse=False,
            pass_bytes=union_pass_bytes(n, 1, n_rows, k_max, block, krylov_dtype=krylov_dtype),
        )
    fixed = union_pass_bytes(n, 0, n_rows, k_max, block, krylov_dtype=krylov_dtype)
    per_column = union_pass_bytes(n, 1, n_rows, k_max, block, krylov_dtype=krylov_dtype) - fixed
    ft = max(1, min(f, capacity // n, (L2_BUDGET_BYTES - fixed) // per_column))
    table = _F_TILE_TABLE.get((block, str(dtype).removeprefix("torch.")), ())
    ft = max((c for c in table if c <= ft), default=ft)
    return Tiling(
        f_tile=ft,
        fuse=True,
        pass_bytes=union_pass_bytes(n, ft, n_rows, k_max, block, krylov_dtype=krylov_dtype),
    )
