"""Wrappers of the Block-ELL Chebyshev CUDA kernels.

Mirrors ``repro/kernels/cheb_bsr.py``: ``cheb_step_cuda`` is the
counterpart of ``cheb_step_pallas`` and ``cheb_union_cuda`` of
``cheb_union_pallas``. ``cheb_adjoint_union_cuda``, the union apply's
adjoint in one launch, has no counterpart there (the reference runs the
adjoint as the plain recurrence). The kernels themselves are in
``csrc/cheb_bsr.cu``.

Each wrapper takes its path from the device of the tensors it is given:
CPU tensors go to the plain versions in ``kernels/ref.py``; CUDA tensors
go to the CUDA kernel, and any failure to build or launch raises. Each
wrapper counts its CUDA launches in a plain integer attribute
``launches`` (CPU calls do not count); ``launch_counts`` reads them all,
``add_launches`` adds to them (what a replayed CUDA graph, which runs no
Python, uses) and ``reset_launch_counts`` sets them to 0.

Block columns are not range-checked here, which would cost a device
synchronisation per launch: ``BlockEll`` checks them when it is built, and
the kernels never read through a column outside ``[0, n_rows)`` (the rows
that name one come out NaN).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import cached_upload
from repro_torch.kernels import ref
from repro_torch.kernels._build import load_library
from repro_torch.kernels.autotune import UNION_BLOCKS, device_sm_count, select_tiling

__all__ = [
    "add_launches",
    "cheb_adjoint_union_cuda",
    "cheb_step_cuda",
    "cheb_union_cuda",
    "device_coeffs",
    "launch_counts",
    "reset_launch_counts",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return _DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(f"{what} must be float32 or bfloat16, got {t.dtype}") from None


def _check_operands(blocks, cols, signals: dict) -> tuple[int, int, int, int]:
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be (n_rows, k_max, B, B), got {tuple(blocks.shape)}")
    n_rows, k_max, b, _ = blocks.shape
    if tuple(cols.shape) != (n_rows, k_max) or cols.dtype != torch.int32:
        raise ValueError(
            f"cols must be int32 (n_rows, k_max) = {(n_rows, k_max)}, got "
            f"{cols.dtype} {tuple(cols.shape)}"
        )
    f = None
    for name, t in signals.items():
        if t.dim() != 2 or t.shape[0] != n_rows * b:
            raise ValueError(f"{name} must be (N, F) with N = {n_rows * b}, got {tuple(t.shape)}")
        if f is not None and t.shape[1] != f:
            raise ValueError(f"{name} has F = {t.shape[1]}, expected {f}")
        f = t.shape[1]
    devices = {blocks.device, cols.device, *(t.device for t in signals.values())}
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {sorted(map(str, devices))}")
    return n_rows, k_max, b, f


def _cuda_ready(tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("CUDA kernel operands must be contiguous")


def _check_index_range(n: int, f: int) -> None:
    """The kernels index an (N, F) signal with 32-bit integers."""
    if n * f >= 2**31:
        raise ValueError(f"N * F = {n * f} must be below 2**31 (32-bit indices)")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


def cheb_step_cuda(
    blocks: torch.Tensor,
    cols: torch.Tensor,
    t1: torch.Tensor,
    t2: torch.Tensor,
    *,
    alpha: float,
    first: bool = False,
    f_tile: int | None = None,
) -> torch.Tensor:
    """One fused Chebyshev recurrence step on Block-ELL operands.

    Args:
      blocks: (n_rows, k_max, B, B) tiles, float32 or bfloat16.
      cols:   (n_rows, k_max) int32 block columns (padding: col 0 + zero tile).
      t1: (N, F) ``T_{k-1}``, float32 or bfloat16, N = n_rows * B.
      t2: (N, F) ``T_{k-2}`` in ``t1.dtype`` (ignored when ``first``).
      alpha: lmax / 2.
      first: compute ``T_1 = (L - a I) f / a`` instead of the k >= 2 step.
      f_tile: signal columns per launch slab (default ``min(F, 128)``).

    Returns: (N, F) ``T_k`` in ``t1.dtype``.

    On CUDA tensors ``B`` = 8 and 16 take the strip kernel (``B`` a
    template parameter, 16-byte aligned tiles), any other ``B`` the generic
    kernel; ``N * F`` must be below 2**31, else ``ValueError``.
    """
    n_rows, k_max, b, f = _check_operands(blocks, cols, {"t1": t1, "t2": t2})
    if t2.dtype != t1.dtype:
        raise TypeError(f"t2 dtype {t2.dtype} differs from t1 dtype {t1.dtype}")
    ft = f_tile or min(f, 128)
    if ft < 1:
        raise ValueError(f"f_tile must be >= 1, got {ft}")
    if t1.device.type == "cpu":
        return ref.cheb_step_ref(blocks, cols, t1, t2, alpha, first=first)
    if t1.device.type != "cuda":
        raise ValueError(f"unsupported device {t1.device}")
    bcode = _dtype_code(blocks, "blocks")
    tcode = _dtype_code(t1, "t1")
    _check_index_range(n_rows * b, f)
    _cuda_ready((blocks, cols, t1, t2))
    ca, cb, cc = ref.step_constants(alpha, first)
    out = torch.empty_like(t1)
    lib = load_library()
    err = lib.cheb_step_launch(
        blocks.data_ptr(), bcode, cols.data_ptr(), t1.data_ptr(), t2.data_ptr(),
        out.data_ptr(), tcode, n_rows, k_max, b, f, ft, ca, cb, cc,
        torch.cuda.current_stream(t1.device).cuda_stream,
    )
    _raise_on(err, "cheb_step_cuda launch")
    cheb_step_cuda.launches += 1
    return out


cheb_step_cuda.launches = 0


def device_coeffs(coeffs, device: torch.device) -> torch.Tensor:
    """A float64 host coefficient array (any shape) as a contiguous float32
    tensor on ``device``, uploaded once per distinct array rather than once
    per apply (a host-to-device copy synchronises the stream, and cannot
    run inside a recorded CUDA graph). A joint tensor goes up whole; its
    slices are device views."""
    return cached_upload(np.asarray(coeffs, dtype=np.float64), device, torch.float32)


def _series(coeffs, device: torch.device):
    """(eta, M+1) coefficients, M >= 1: a float64 host array, or a tensor
    that must be on ``device``."""
    if isinstance(coeffs, torch.Tensor):
        c = torch.atleast_2d(coeffs)
        if c.device != device:
            raise ValueError(f"coeffs are on {c.device}, the signal on {device}")
    else:
        c = np.atleast_2d(np.asarray(coeffs, dtype=np.float64))
    if c.ndim != 2:
        raise ValueError(f"coeffs must be (eta, M+1), got shape {tuple(c.shape)}")
    if c.shape[1] < 2:
        raise ValueError("need at least order 1 (two coefficients)")
    return c


def _coeffs_on_device(c, device: torch.device) -> torch.Tensor:
    """``_series``'s coefficients as the kernels read them: contiguous
    float32 on ``device``, uploaded once per distinct host array."""
    if isinstance(c, torch.Tensor):
        return c.to(torch.float32).contiguous()
    return device_coeffs(c, device)


def cheb_union_cuda(
    blocks: torch.Tensor,
    cols: torch.Tensor,
    f: torch.Tensor,
    *,
    coeffs,
    lmax: float,
    f_tile: int | None = None,
    krylov_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Full union apply ``Phi~ f`` (eq. 9 + eq. 11) in one launch.

    Args:
      blocks: (n_rows, k_max, B, B) float32 tiles.
      cols: (n_rows, k_max) int32 block columns.
      f: (N, F) float32 signals.
      coeffs: (eta, M+1) Chebyshev coefficients, M >= 1: a host array
        (uploaded once per distinct array, see ``device_coeffs``) or a
        tensor on ``f``'s device (used as it is, cast to float32).
      lmax: spectrum bound.
      f_tile: signal columns per resident pass (default from
        ``autotune.select_tiling``: as many as the card's resident grid and
        the L2 budget hold).
      krylov_dtype: float32 or bfloat16 ping/pong buffers; the math and
        the accumulators stay float32.

    Returns: (eta, N, F) in ``f.dtype``.

    On CUDA tensors ``B`` must be one the kernel is built for
    (``autotune.UNION_BLOCKS``), else ``ValueError``.
    """
    n_rows, k_max, b, fdim = _check_operands(blocks, cols, {"f": f})
    c = _series(coeffs, f.device)
    eta, order = c.shape[0], c.shape[1] - 1
    if krylov_dtype not in _DTYPE_CODE:
        raise TypeError(f"krylov_dtype must be float32 or bfloat16, got {krylov_dtype}")
    if f.device.type == "cpu":
        return ref.cheb_union_ref(blocks, cols, f, c, lmax, krylov_dtype=krylov_dtype)
    if f.device.type != "cuda":
        raise ValueError(f"unsupported device {f.device}")
    if blocks.dtype != torch.float32 or f.dtype != torch.float32:
        raise TypeError(f"blocks and f must be float32, got {blocks.dtype} and {f.dtype}")
    if b not in UNION_BLOCKS:
        raise ValueError(
            f"the fused kernel is built for B in {UNION_BLOCKS}, got B = {b}; "
            "use the stepwise chain (fuse=False)"
        )
    n = n_rows * b
    _check_index_range(n, fdim)
    _cuda_ready((blocks, cols, f))
    if f_tile is None:
        tiling = select_tiling(n, fdim, eta, n_rows, k_max, b, f.dtype,
                               krylov_dtype=krylov_dtype, sm_count=device_sm_count(f.device))
        if not tiling.fuse:
            raise ValueError(
                f"N = {n} exceeds what one resident pass of the fused kernel holds; "
                "use the stepwise chain (fuse=False)"
            )
        f_tile = tiling.f_tile
    if f_tile < 1:
        raise ValueError(f"f_tile must be >= 1, got {f_tile}")
    coeffs_dev = _coeffs_on_device(c, f.device)
    ta = torch.empty((n, fdim), dtype=krylov_dtype, device=f.device)
    tb = torch.empty_like(ta)
    out = torch.empty((eta, n, fdim), dtype=f.dtype, device=f.device)
    alpha = lmax / 2.0
    lib = load_library()
    err = lib.cheb_union_launch(
        blocks.data_ptr(), cols.data_ptr(), f.data_ptr(), coeffs_dev.data_ptr(),
        ta.data_ptr(), tb.data_ptr(), _DTYPE_CODE[krylov_dtype], out.data_ptr(),
        n_rows, k_max, b, fdim, eta, order, f_tile, 1.0 / alpha, 2.0 / alpha,
        torch.cuda.current_stream(f.device).cuda_stream,
    )
    _raise_on(err, "cheb_union_cuda launch")
    cheb_union_cuda.launches += 1
    return out


cheb_union_cuda.launches = 0


def cheb_adjoint_union_cuda(
    blocks: torch.Tensor,
    cols: torch.Tensor,
    a: torch.Tensor,
    *,
    coeffs,
    lmax: float,
    f_tile: int | None = None,
) -> torch.Tensor:
    """The union apply's adjoint ``Phi~* a`` (eq. 13) in one launch.

    The transposed union recurrence: with ``L`` symmetric it is the
    Chebyshev series ``sum_k Tbar_k(L) z_k``, ``z_k = sum_j c_{j,k} a_j``
    (``c_{j,0}`` halved), summed by Clenshaw's recurrence; M matvecs on F
    columns, the contraction with the coefficients fused into them.

    Args:
      blocks: (n_rows, k_max, B, B) float32 tiles.
      cols: (n_rows, k_max) int32 block columns.
      a: (eta, N, F) float32 stacked coefficient signals, or (eta, N).
      coeffs: (eta, M+1) Chebyshev coefficients, M >= 1: a host array
        (uploaded once per distinct array, see ``device_coeffs``) or a
        tensor on ``a``'s device (used as it is, cast to float32).
      lmax: spectrum bound.
      f_tile: signal columns per resident pass (default from
        ``autotune.select_tiling(..., adjoint=True)``).

    Returns: (N, F), or (N,) for an (eta, N) input, in ``a.dtype``.

    On CUDA tensors ``B`` must be one the kernel is built for
    (``autotune.UNION_BLOCKS``), else ``ValueError``.
    """
    if a.dim() not in (2, 3):
        raise ValueError(f"a must be (eta, N, F) or (eta, N), got {tuple(a.shape)}")
    squeeze = a.dim() == 2
    a3 = a[:, :, None] if squeeze else a
    n_rows, k_max, b, fdim = _check_operands(blocks, cols, {"a[0]": a3[0]})
    c = _series(coeffs, a.device)
    eta, order = c.shape[0], c.shape[1] - 1
    if a.shape[0] != eta:
        raise ValueError(f"adjoint input has {a.shape[0]} blocks, coeffs {eta}")
    if a.device.type == "cpu":
        return ref.cheb_adjoint_union_ref(blocks, cols, a, c, lmax)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if blocks.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"blocks and a must be float32, got {blocks.dtype} and {a.dtype}")
    if b not in UNION_BLOCKS:
        raise ValueError(
            f"the fused adjoint kernel is built for B in {UNION_BLOCKS}, got B = {b}; "
            "use the plain recurrence (chebyshev.cheb_adjoint_apply)"
        )
    n = n_rows * b
    _check_index_range(n, fdim)
    _cuda_ready((blocks, cols, a3))
    if f_tile is None:
        tiling = select_tiling(n, fdim, eta, n_rows, k_max, b, a.dtype,
                               sm_count=device_sm_count(a.device), adjoint=True)
        if not tiling.fuse:
            raise ValueError(
                f"N = {n} exceeds what one resident pass of the fused kernel holds; "
                "use the plain recurrence (chebyshev.cheb_adjoint_apply)"
            )
        f_tile = tiling.f_tile
    if f_tile < 1:
        raise ValueError(f"f_tile must be >= 1, got {f_tile}")
    coeffs_dev = _coeffs_on_device(c, a.device)
    ba = torch.empty((n, fdim), dtype=torch.float32, device=a.device)
    bb = torch.empty_like(ba)
    out = torch.empty((n, fdim), dtype=a.dtype, device=a.device)
    alpha = lmax / 2.0
    lib = load_library()
    err = lib.cheb_adjoint_union_launch(
        blocks.data_ptr(), cols.data_ptr(), a3.data_ptr(), coeffs_dev.data_ptr(),
        ba.data_ptr(), bb.data_ptr(), out.data_ptr(),
        n_rows, k_max, b, fdim, eta, order, f_tile, 1.0 / alpha, 2.0 / alpha,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _raise_on(err, "cheb_adjoint_union_cuda launch")
    cheb_adjoint_union_cuda.launches += 1
    return out[:, 0] if squeeze else out


cheb_adjoint_union_cuda.launches = 0


_COUNTED = (cheb_union_cuda, cheb_step_cuda, cheb_adjoint_union_cuda)


def launch_counts() -> tuple[int, ...]:
    """Every wrapper's launch count: union kernel, step, adjoint."""
    return tuple(w.launches for w in _COUNTED)


def add_launches(delta) -> None:
    """Add ``delta`` (ordered as ``launch_counts``) to the counts."""
    for w, d in zip(_COUNTED, delta, strict=True):
        w.launches += d


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for w in _COUNTED:
        w.launches = 0
