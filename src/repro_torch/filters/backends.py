"""The port's ``GraphFilter`` backends.

Mirrors ``repro/filters/backends.py`` for its single-device backends:

* ``dense``  — dense Laplacian ``torch.matmul`` and a Python-loop
               recurrence; the parity oracle for the others.
* ``bsr``    — Block-ELL: the fused union kernel when ``select_tiling``
               says it can hold the apply (one launch per apply), the
               stepwise chain otherwise (M launches per apply).
* ``matvec`` — no graph: the caller supplies ``matvec=`` computing
               ``L @ v``.

Where the reference switches Pallas to interpret mode off the TPU, the
port switches on the signal's device: CUDA tensors reach the CUDA
kernels (or the call raises), CPU tensors their plain versions. The
halo, allgather and grid backends come with the distributed slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import chebyshev
from repro_torch.core import graph as graph_lib
from repro_torch.filters.registry import BackendCapabilities, register_backend
from repro_torch.kernels import autotune, ops as kops, ref as kref

__all__ = ["DenseBackend", "BsrBackend", "MatvecBackend"]


def _require_graph(filt, name: str):
    if filt.graph is None:
        raise ValueError(
            f"backend {name!r} needs a bound graph; build the filter with "
            "graph=... or call filt.bind(graph)"
        )
    return filt.graph


def _coeffs_or(filt, coeffs) -> np.ndarray:
    return np.atleast_2d(np.asarray(filt.coeffs if coeffs is None else coeffs))


def _check_device(x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"signal is on {x.device}, the prepared graph on {device}")


@register_backend
class MatvecBackend:
    """Graph-free backend: ``filt.apply(f, backend="matvec", matvec=fn)``
    runs the recurrence with ``fn(v) = L @ v``."""

    name = "matvec"
    prepare_opts: frozenset[str] = frozenset()
    capabilities = BackendCapabilities(traceable=True)

    def prepare(self, filt, **_):
        return None

    def apply(self, filt, state, f, *, coeffs=None, matvec=None, **_):
        if matvec is None:
            raise ValueError("backend 'matvec' requires matvec=")
        return chebyshev.cheb_apply(matvec, f, _coeffs_or(filt, coeffs), filt.lmax)

    def adjoint(self, filt, state, a, *, matvec=None, **_):
        if matvec is None:
            raise ValueError("backend 'matvec' requires matvec=")
        return chebyshev.cheb_adjoint_apply(matvec, a, filt.coeffs, filt.lmax)

    def messages_per_apply(self, filt, state, matvec_counts) -> int:
        return 0


@register_backend
class DenseBackend:
    """Dense reference backend: ``torch.matmul`` against the dense
    Laplacian, as the reference leaves ``lap @ v`` to XLA."""

    name = "dense"
    prepare_opts: frozenset[str] = frozenset()
    capabilities = BackendCapabilities(traceable=True)

    def prepare(self, filt, **_):
        return _require_graph(filt, self.name).laplacian()

    def apply(self, filt, lap, f, *, coeffs=None, **_):
        _check_device(f, lap.device)
        return chebyshev.cheb_apply(lambda v: lap @ v, f, _coeffs_or(filt, coeffs), filt.lmax)

    def adjoint(self, filt, lap, a, **_):
        # tensordot: the adjoint recurrence carries the eta blocks in
        # trailing dims, so contract the vertex axis explicitly.
        _check_device(a, lap.device)
        return chebyshev.cheb_adjoint_apply(
            lambda v: torch.tensordot(lap, v, dims=1), a, filt.coeffs, filt.lmax
        )

    def messages_per_apply(self, filt, state, matvec_counts) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class _BsrState:
    bell: kref.BlockEll
    perm: torch.Tensor  # vertex permutation applied before tiling
    inv: torch.Tensor  # positions of the true vertices in permuted order
    n: int  # true vertex count
    n_pad: int


@register_backend
class BsrBackend:
    """Block-ELL backend on the CUDA kernels.

    ``prepare`` reorders the vertices by recursive coordinate bisection
    (host numpy, as the reference) so nonzeros cluster into dense tiles,
    then tiles the permuted Laplacian into Block-ELL on the graph's
    device. ``apply`` runs the fused kernel when ``select_tiling`` says
    it can hold the apply, else the stepwise chain.

    Options: ``block_size`` (prepare; default 8), ``fuse`` and ``f_tile``
    overrides, and ``krylov_dtype`` (apply; default float32, or
    ``"bfloat16"`` to round only the stored Krylov vectors).
    """

    name = "bsr"
    prepare_opts: frozenset[str] = frozenset({"block_size"})
    capabilities = BackendCapabilities(traceable=True)

    def prepare(self, filt, *, block_size: int = 8, **_):
        g = _require_graph(filt, self.name)
        n = g.n_vertices
        if g.coords is not None:
            perm = graph_lib.spatial_partition_order(
                g.coords.cpu().numpy(), max(n // block_size, 1)
            )
        else:
            perm = np.arange(n)
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        dev = g.device
        perm_t = torch.as_tensor(perm, device=dev)
        lap = g.laplacian()[perm_t][:, perm_t]
        bell = kref.bsr_from_dense(lap, block_size)
        return _BsrState(
            bell=bell, perm=perm_t, inv=torch.as_tensor(inv, device=dev), n=n, n_pad=bell.n
        )

    def _forward(self, state: _BsrState, f: torch.Tensor):
        """Permute + pad an (N, ...) signal into kernel layout."""
        _check_device(f, state.perm.device)
        squeeze = f.ndim == 1
        f2 = f[:, None] if squeeze else f
        fp = F.pad(f2[state.perm], (0, 0, 0, state.n_pad - state.n))
        return fp.contiguous(), squeeze

    def apply(
        self,
        filt,
        state: _BsrState,
        f,
        *,
        coeffs=None,
        f_tile: int | None = None,
        fuse: bool | None = None,
        krylov_dtype=None,
        **_,
    ):
        c = _coeffs_or(filt, coeffs)
        kd = _torch_dtype(krylov_dtype)
        fp, squeeze = self._forward(state, f)
        bell = state.bell
        if fuse is None:
            fuse = autotune.select_tiling(
                state.n_pad, fp.shape[1], c.shape[0],
                bell.n_block_rows, bell.k_max, bell.block_size, fp.dtype,
                krylov_dtype=kd, sm_count=autotune.device_sm_count(fp.device),
            ).fuse
        if fuse:
            out = kops.cheb_apply_bsr_fused(
                bell.blocks, bell.cols, fp, c, filt.lmax, f_tile=f_tile, krylov_dtype=kd
            )
        else:
            out = kops.cheb_apply_bsr(
                bell.blocks, bell.cols, fp, c, filt.lmax,
                f_tile=f_tile, krylov_dtype=kd,
            )
        out = out[:, state.inv]
        return out[:, :, 0] if squeeze else out

    def adjoint(self, filt, state: _BsrState, a, **_):
        # Same recurrence on eta-stacked blocks (Sec. IV-B) with the plain
        # Block-ELL matvec: the reference has no kernel for the adjoint.
        _check_device(a, state.perm.device)
        squeeze = a.ndim == 2  # (eta, N) -> signals are 1-D
        a3 = a[:, :, None] if squeeze else a
        ap = F.pad(a3[:, state.perm], (0, 0, 0, state.n_pad - state.n))

        def mv(v):
            flat = v.reshape(state.n_pad, -1)
            return kref.bsr_matvec_ref(state.bell, flat).reshape(v.shape)

        out = chebyshev.cheb_adjoint_apply(mv, ap, filt.coeffs, filt.lmax)
        out = out[state.inv]
        return out[:, 0] if squeeze else out

    def messages_per_apply(self, filt, state, matvec_counts) -> int:
        return 0  # single device: HBM traffic, not network words


def _torch_dtype(name) -> torch.dtype:
    """``krylov_dtype=`` accepts a torch dtype or its name."""
    if name is None:
        return torch.float32
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown krylov_dtype {name!r}")
    return dt
