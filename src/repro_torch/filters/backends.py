"""The port's ``GraphFilter`` backends.

Mirrors ``repro/filters/backends.py`` for single-shift filters:

* ``dense``      — dense Laplacian ``torch.matmul`` and a Python-loop
                   recurrence; the parity oracle for the others.
* ``bsr``        — Block-ELL: the fused union kernel when
                   ``select_tiling`` says it can hold the apply (one
                   launch per apply), the stepwise chain otherwise (M
                   launches per apply).
* ``halo``       — vertex partition over a mesh of ranks, per-order
                   boundary (halo) exchange via ``all_to_all`` —
                   Algorithm 1.
* ``allgather``  — naive distributed baseline: full-signal all-gather
                   per order.
* ``grid``       — matrix-free stencil Laplacian on row slabs with the
                   communication-avoiding depth-d schedule (square grid
                   graphs only).
* ``matvec``     — no graph: the caller supplies ``matvec=`` computing
                   ``L @ v``.

Where the reference switches Pallas to interpret mode off the TPU, the
port switches on the signal's device: CUDA tensors reach the CUDA
kernels (or the call raises), CPU tensors their plain versions. The
distributed backends run on a mesh from ``repro_torch.core.collectives``
(``mesh=``, or ``n_parts=`` ranks stacked on the graph's device, or the
initialised ``torch.distributed`` world).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import chebyshev, collectives
from repro_torch.core import graph as graph_lib
from repro_torch.core.distributed import (
    DistributedGraphContext,
    build_partition_plan,
    grid_cheb_apply_ca,
    grid_slab_matvec,
)
from repro_torch.filters.registry import BackendCapabilities, register_backend
from repro_torch.kernels import autotune, ops as kops, ref as kref

__all__ = [
    "DenseBackend",
    "BsrBackend",
    "HaloBackend",
    "AllgatherBackend",
    "GridBackend",
    "MatvecBackend",
]


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


class _ShardedBackendBase:
    """Shared machinery for the partition-plan distributed backends.

    ``state_key`` is shared so halo and allgather reuse one prepared
    ``DistributedGraphContext`` (the plan depends only on graph and mesh,
    not on which matvec consumes it).
    """

    name = "halo"
    state_key = "partition_plan"
    # scatter/gather and the host-side plan make these backends host
    # loops in the solvers (traceable=False), as in the reference.
    capabilities = BackendCapabilities()
    prepare_opts: frozenset[str] = frozenset({"mesh", "n_parts"})

    def prepare(self, filt, *, mesh=None, n_parts: int | None = None, **_):
        g = _require_graph(filt, self.name)
        if mesh is None:
            mesh = collectives.default_mesh(n_parts, g.device)
        plan = build_partition_plan(g.adjacency, g.coords, mesh.n_parts, device=mesh.device)
        return DistributedGraphContext(plan=plan, mesh=mesh)

    def apply(self, filt, ctx, f, *, coeffs=None, overlap: bool | None = None, **_):
        _check_device(f, ctx.mesh.device)
        c = _coeffs_or(filt, coeffs)
        squeeze = f.ndim == 1
        out = ctx.cheb_apply(ctx.scatter_signal(f), c, filt.lmax, backend=self.name,
                             overlap=overlap)
        out = ctx.gather_signal(out)
        return out[:, :, 0] if squeeze else out

    def adjoint(self, filt, ctx, a, **_):
        _check_device(a, ctx.mesh.device)
        squeeze = a.ndim == 2
        a3 = a[:, :, None] if squeeze else a
        out = ctx.cheb_adjoint(ctx.scatter_signal(a3, vertex_dim=1), filt.coeffs, filt.lmax)
        out = ctx.gather_signal(out)
        return out[:, 0] if squeeze else out

    def messages_per_apply(self, filt, ctx, matvec_counts) -> int:
        return ctx.messages_per_apply(matvec_counts[0], backend=self.name)


@register_backend
class HaloBackend(_ShardedBackendBase):
    """Vertex-partitioned distributed backend, halo exchange per order.

    Algorithm 1 on the mesh: rank p sends rank q exactly the boundary
    values q's Laplacian rows touch, one ``all_to_all`` per recurrence
    order. Words per apply = ``M * halo_words <= 2 M |E|``.

    The ``overlap=`` apply option picks the overlapped schedule (True)
    or the serial exchange->matvec one (False); by default the mesh
    picks (``mesh.overlaps``: overlapped on a process group, serial on a
    ``StackedMesh``). Both move exactly the same words. Single-shift only in the port
    (the reference's multi-shift halo state is not ported yet).
    """

    name = "halo"
    capabilities = BackendCapabilities()


@register_backend
class AllgatherBackend(_ShardedBackendBase):
    """Naive distributed baseline: all-gather the full signal per order.

    Words per apply = ``M * n_local * P * (P-1)``. Its adjoint runs the
    halo exchange, as the reference's does.
    """

    name = "allgather"
    capabilities = BackendCapabilities()


@dataclasses.dataclass(frozen=True)
class _GridState:
    side: int
    mesh: object
    n_parts: int
    depth: int


@register_backend
class GridBackend:
    """Matrix-free stencil backend for square 4-neighbour grid graphs.

    Row slabs over the mesh's ranks; each recurrence block exchanges a
    depth-d ghost-row halo once and runs d local steps — the
    communication-avoiding schedule (same words as per-order exchange,
    1/d the neighbour rounds). The Laplacian is never materialized.

    Options: ``mesh`` / ``n_parts`` (prepare), ``depth``
    (prepare; ghost depth d, default 2 capped to rows-per-slab).
    """

    name = "grid"
    # apply/adjoint reshape and gather the slabs around the schedule;
    # host loops in the solvers (traceable=False), as in the reference.
    capabilities = BackendCapabilities()
    prepare_opts: frozenset[str] = frozenset({"mesh", "n_parts", "depth"})

    def prepare(self, filt, *, mesh=None, n_parts: int | None = None, depth: int = 2, **_):
        g = _require_graph(filt, self.name)
        n = g.n_vertices
        side = int(round(math.sqrt(n)))
        if side * side != n:
            raise ValueError(f"grid backend needs a square grid graph, got N={n}")
        # Structural validation at every scale (on the graph's device):
        # unit weights, the stencil degree field and the exact edge count
        # together pin down the 4-neighbour grid.
        a = g.adjacency
        deg = a.sum(dim=1).reshape(side, side)
        want_deg = torch.full((side, side), 4.0, dtype=a.dtype, device=a.device)
        want_deg[0, :] -= 1.0
        want_deg[-1, :] -= 1.0
        want_deg[:, 0] -= 1.0
        want_deg[:, -1] -= 1.0
        n_edges_want = 2 * side * (side - 1)
        if (not bool(((a == 0.0) | (a == 1.0)).all())
                or not torch.equal(deg, want_deg)
                or int(torch.count_nonzero(a)) != 2 * n_edges_want):
            raise ValueError(
                "grid backend: adjacency is not the unit-weight "
                f"4-neighbour {side}x{side} grid"
            )
        if n <= 4096:  # exact check is cheap at test scales
            want = graph_lib.grid_graph(side, a.dtype, device=a.device).adjacency
            if not torch.equal(a, want):
                raise ValueError(
                    "grid backend: adjacency is not the unit-weight "
                    f"4-neighbour {side}x{side} grid"
                )
        if mesh is None:
            mesh = collectives.default_mesh(n_parts, g.device)
        p = mesh.n_parts
        if side % p != 0:
            raise ValueError(f"side={side} not divisible by n_parts={p}")
        depth = max(1, min(depth, side // p))
        return _GridState(side=side, mesh=mesh, n_parts=p, depth=depth)

    @staticmethod
    def _slabs(state: _GridState, x: torch.Tensor, vertex_dim: int) -> torch.Tensor:
        """(.., N, ..) -> the local ranks' row slabs (.., R, n_local, ..)."""
        slabs = x.unflatten(vertex_dim, (state.n_parts, -1))
        return state.mesh.local_rows(slabs, vertex_dim)

    def apply(self, filt, state: _GridState, f, *, coeffs=None, **_):
        _check_device(f, state.mesh.device)
        squeeze = f.ndim == 1
        f2 = f[:, None] if squeeze else f
        out = grid_cheb_apply_ca(self._slabs(state, f2, 0), _coeffs_or(filt, coeffs),
                                 filt.lmax, side=state.side, mesh=state.mesh,
                                 depth=state.depth)
        out = state.mesh.gather_ranks(out, 1).flatten(1, 2)
        return out[:, :, 0] if squeeze else out

    def adjoint(self, filt, state: _GridState, a, **_):
        _check_device(a, state.mesh.device)
        squeeze = a.ndim == 2
        a3 = a[:, :, None] if squeeze else a

        def mv(v):  # (R, n_local, F, eta) — flatten for the stencil
            flat = v.reshape(v.shape[0], v.shape[1], -1)
            return grid_slab_matvec(flat, side=state.side, mesh=state.mesh).reshape(v.shape)

        out = chebyshev.cheb_adjoint_apply(mv, self._slabs(state, a3, 1), filt.coeffs, filt.lmax)
        out = state.mesh.gather_ranks(out, 0).flatten(0, 1)
        return out[:, 0] if squeeze else out

    def messages_per_apply(self, filt, state: _GridState, matvec_counts) -> int:
        # one (side,) boundary row up + down per order across P-1 seams;
        # the CA schedule moves the same words in order/depth rounds.
        return matvec_counts[0] * 2 * (state.n_parts - 1) * state.side


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
