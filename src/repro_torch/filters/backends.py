"""The port's ``GraphFilter`` backends.

Mirrors ``repro/filters/backends.py``:

* ``dense``      — dense Laplacian ``torch.matmul`` and a Python-loop
                   recurrence; the parity oracle for the others.
* ``bsr``        — Block-ELL: the fused union kernel when
                   ``select_tiling`` says it can hold the apply (one
                   launch per apply), the stepwise chain otherwise (M
                   launches per apply); the adjoint likewise in one
                   launch of the fused adjoint kernel, or the plain
                   recurrence.
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

``dense``, ``bsr`` and ``halo`` also run multi-shift joint filters
(``GraphFilter.from_shifts``): one operand per shift, the joint
recurrence of ``chebyshev.cheb_apply_joint``. On ``bsr`` its innermost
level is a single-shift union apply of the last shift, dispatched to the
fused kernel or the stepwise chain as a single-shift apply is.

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
    MultiShiftGraphContext,
    _host,
    build_partition_plan,
    build_shift_partition_plans,
    grid_cheb_apply_ca,
    grid_slab_matvec,
)
from repro_torch.filters.api import bucket_size, gather_reach
from repro_torch.filters.registry import (
    BackendCapabilities,
    register_backend,
    require_capability,
)
from repro_torch.kernels import autotune, cheb_bsr, ops as kops, ref as kref
from repro_torch.telemetry import span

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


def _restricted_cheb_apply(lap_sub, d_sub, coeffs, lmax):
    """Recurrence on the induced submatrix over the order-hop reach.

    Exact, not approximate: every length-k walk (k <= M) from the delta's
    support stays inside the M-hop neighbourhood, so the polynomial in the
    *submatrix* of L (true degrees on the diagonal) agrees with the full
    filter on that neighbourhood (DESIGN.md Sec. 8).
    """
    return chebyshev.cheb_apply(lambda v: lap_sub @ v, d_sub, coeffs, lmax)


@register_backend
class DenseBackend:
    """Dense reference backend: ``torch.matmul`` against the dense
    Laplacian, as the reference leaves ``lap @ v`` to XLA. It declares
    ``sparse_input``: ``apply_sparse`` restricts the recurrence to the
    order-hop reach of the delta's support."""

    name = "dense"
    prepare_opts: frozenset[str] = frozenset()
    capabilities = BackendCapabilities(traceable=True, sparse_input=True, multi_shift=True)

    def prepare(self, filt, **_):
        _require_graph(filt, self.name)
        # One dense Laplacian per shift; apply branches on the tuple.
        laps = tuple(s.laplacian() for s in filt.shift_graphs)
        return laps if filt.n_shifts > 1 else laps[0]

    @staticmethod
    def _matvecs(laps: tuple):
        return [lambda v, m=m: torch.tensordot(m, v, dims=1) for m in laps]

    def apply_sparse(self, filt, lap, delta, support, *, coeffs=None, reach=None, **_):
        """``Phi~ delta`` for ``delta`` supported on ``support``: the
        recurrence on the induced submatrix over the M-hop reach only.

        The submatrix size is rounded up to a power-of-two bucket so a
        stream of slightly varying change sets keeps a handful of shapes.
        ``reach=`` takes a precomputed (N,) host boolean M-hop mask;
        without it the reach is walked here on the host (which reads the
        adjacency back from the graph's device). When the bucket reaches
        N, the full apply is the same work without the scatter. The gather
        of ``L[R, R]`` into a zero (b, b) submatrix and the scatter back
        are device ops after one upload of the reach's indices.
        """
        c = _coeffs_or(filt, coeffs)
        g = _require_graph(filt, self.name)
        _check_device(delta, lap.device)
        if reach is None:
            reach = graph_lib.khop_neighborhood(
                _host(g.adjacency), _host(support), c.shape[1] - 1
            )
        idx = np.nonzero(_host(reach))[0]
        n, k = delta.shape[0], len(idx)
        b = bucket_size(k, n)
        if b >= n:
            return self.apply(filt, lap, delta, coeffs=coeffs)
        squeeze = delta.ndim == 1
        d2 = delta[:, None] if squeeze else delta
        idx_t, lap_sub, d_sub = gather_reach(lap, idx, b, d2)
        out_sub = _restricted_cheb_apply(
            lap_sub, d_sub, cheb_bsr.device_coeffs(c, lap.device), filt.lmax
        )
        out = d2.new_zeros((c.shape[0],) + d2.shape)
        out[:, idx_t] = out_sub[:, :k]
        return out[:, :, 0] if squeeze else out

    def apply(self, filt, lap, f, *, coeffs=None, **_):
        c = _coeffs_or(filt, coeffs)
        if isinstance(lap, tuple):
            _check_device(f, lap[0].device)
            return chebyshev.cheb_apply_joint(self._matvecs(lap), f, c, filt.shift_lmaxes)
        _check_device(f, lap.device)
        return chebyshev.cheb_apply(lambda v: lap @ v, f, c, filt.lmax)

    def adjoint(self, filt, lap, a, **_):
        # tensordot: the adjoint recurrence carries the eta blocks in
        # trailing dims, so contract the vertex axis explicitly.
        if isinstance(lap, tuple):
            _check_device(a, lap[0].device)
            return chebyshev.cheb_adjoint_apply_joint(
                self._matvecs(lap), a, filt.coeffs, filt.shift_lmaxes
            )
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


@dataclasses.dataclass(frozen=True)
class _BsrMultiState:
    """Multi-shift Block-ELL state: one tiling per shift over one layout.

    Every shift's Laplacian is permuted by the same spatial order (taken
    from the first shift's coordinates) and padded to the same ``n_pad``,
    so the joint recurrence interleaves per-shift matvecs on one signal
    layout.
    """

    bells: tuple
    perm: torch.Tensor
    inv: torch.Tensor
    n: int
    n_pad: int


@register_backend
class BsrBackend:
    """Block-ELL backend on the CUDA kernels.

    ``prepare`` reorders the vertices by recursive coordinate bisection
    (host numpy, as the reference) so nonzeros cluster into dense tiles,
    then tiles the permuted Laplacian into Block-ELL on the graph's
    device. ``apply`` runs the fused kernel when ``select_tiling`` says
    it can hold the apply, else the stepwise chain; ``adjoint`` runs the
    fused adjoint kernel when ``select_tiling(..., adjoint=True)`` says it
    can (``fuse=`` does not reach it), else the plain Block-ELL
    recurrence.

    Options: ``block_size`` (prepare; default 8), ``fuse`` and ``f_tile``
    overrides, and ``krylov_dtype`` (apply; default float32, or
    ``"bfloat16"`` to round only the stored Krylov vectors).

    A multi-shift filter gets one tiling per shift over one layout. Its
    joint recurrence runs the outer shifts with the plain Block-ELL
    matvec, as the reference's does, and the innermost level (the last
    shift, one union apply per combination of outer Krylov vectors:
    ``prod_{s<R}(M_s + 1)`` of them) through the same fused/stepwise
    dispatch as a single-shift apply. The joint coefficients go to the
    device once per coefficient tensor, and each innermost call gets a
    device slice. Its adjoint stays the plain Block-ELL recurrence.
    """

    name = "bsr"
    prepare_opts: frozenset[str] = frozenset({"block_size"})
    capabilities = BackendCapabilities(traceable=True, multi_shift=True)

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
        inv_t = torch.as_tensor(inv, device=dev)
        bells = tuple(
            kref.bsr_from_dense(s.laplacian()[perm_t][:, perm_t], block_size)
            for s in filt.shift_graphs
        )
        if filt.n_shifts > 1:
            return _BsrMultiState(bells=bells, perm=perm_t, inv=inv_t, n=n, n_pad=bells[0].n)
        return _BsrState(bell=bells[0], perm=perm_t, inv=inv_t, n=n, n_pad=bells[0].n)

    def _forward(self, state: _BsrState, f: torch.Tensor):
        """Permute + pad an (N, ...) signal into kernel layout."""
        _check_device(f, state.perm.device)
        squeeze = f.ndim == 1
        f2 = f[:, None] if squeeze else f
        with span("bsr.permute"):
            fp = F.pad(f2[state.perm], (0, 0, 0, state.n_pad - state.n)).contiguous()
        return fp, squeeze

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
        if isinstance(state, _BsrMultiState):
            lmaxes = filt.shift_lmaxes

            def inner(v, c_slice):
                return self._union_apply(state.bells[-1], v.contiguous(), c_slice, lmaxes[-1],
                                         fuse=fuse, f_tile=f_tile, krylov_dtype=kd)

            out = chebyshev.cheb_apply_joint(
                [self._bell_matvec(b, state.n_pad) for b in state.bells], fp,
                cheb_bsr.device_coeffs(c, fp.device), lmaxes, inner=inner,
            )
        else:
            out = self._union_apply(state.bell, fp, c, filt.lmax, fuse=fuse, f_tile=f_tile,
                                    krylov_dtype=kd)
        with span("bsr.unpermute"):
            out = out[:, state.inv]
        return out[:, :, 0] if squeeze else out

    @staticmethod
    def _union_apply(bell, fp, c, lmax, *, fuse, f_tile, krylov_dtype):
        """One single-shift union apply on Block-ELL operands: the fused
        kernel when ``select_tiling`` (or ``fuse=``) says so, else the
        stepwise chain. ``c`` is (eta, M+1), host array or device tensor."""
        if fuse is None:
            with span("bsr.tiling"):
                fuse = autotune.select_tiling(
                    fp.shape[0], fp.shape[1], c.shape[0],
                    bell.n_block_rows, bell.k_max, bell.block_size, fp.dtype,
                    krylov_dtype=krylov_dtype, sm_count=autotune.device_sm_count(fp.device),
                ).fuse
        union = kops.cheb_apply_bsr_fused if fuse else kops.cheb_apply_bsr
        with span("bsr.union"):
            return union(bell.blocks, bell.cols, fp, c, lmax, f_tile=f_tile,
                         krylov_dtype=krylov_dtype)

    @staticmethod
    def _bell_matvec(bell, n_pad: int):
        """Plain Block-ELL matvec closure handling any trailing dims."""

        def mv(v):
            flat = v.reshape(n_pad, -1)
            return kref.bsr_matvec_ref(bell, flat).reshape(v.shape)

        return mv

    def adjoint(self, filt, state, a, **_):
        # A single-shift adjoint runs the fused adjoint kernel (the
        # transposed union recurrence, one launch) wherever the adjoint's
        # select_tiling fuses, whatever the apply's fuse=; otherwise, and
        # for a joint filter, the same recurrence on eta-stacked blocks
        # (Sec. IV-B) with the plain Block-ELL matvec, as the reference
        # runs every adjoint.
        _check_device(a, state.perm.device)
        squeeze = a.ndim == 2  # (eta, N) -> signals are 1-D
        a3 = a[:, :, None] if squeeze else a
        with span("bsr.permute"):
            ap = F.pad(a3[:, state.perm], (0, 0, 0, state.n_pad - state.n))
        c = cheb_bsr.device_coeffs(filt.coeffs, ap.device)
        with span("bsr.recurrence"):
            if isinstance(state, _BsrMultiState):
                out = chebyshev.cheb_adjoint_apply_joint(
                    [self._bell_matvec(b, state.n_pad) for b in state.bells], ap, c,
                    filt.shift_lmaxes,
                )
            else:
                bell = state.bell
                with span("bsr.tiling"):
                    tiling = autotune.select_tiling(
                        ap.shape[1], ap.shape[2], ap.shape[0], bell.n_block_rows, bell.k_max,
                        bell.block_size, ap.dtype, sm_count=autotune.device_sm_count(ap.device),
                        adjoint=True,
                    )
                if tiling.fuse:
                    out = cheb_bsr.cheb_adjoint_union_cuda(bell.blocks, bell.cols, ap, coeffs=c,
                                                           lmax=filt.lmax, f_tile=tiling.f_tile)
                else:
                    out = chebyshev.cheb_adjoint_apply(
                        self._bell_matvec(bell, state.n_pad), ap, c, filt.lmax
                    )
        with span("bsr.unpermute"):
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
        if filt.n_shifts > 1:
            # One layout from the union edge pattern, one plan per shift.
            plans = build_shift_partition_plans(
                [s.adjacency for s in filt.shifts], g.coords, mesh.n_parts,
                device=mesh.device,
            )
            return MultiShiftGraphContext(plans=plans, mesh=mesh, lmaxes=filt.shift_lmaxes)
        plan = build_partition_plan(g.adjacency, g.coords, mesh.n_parts, device=mesh.device)
        return DistributedGraphContext(plan=plan, mesh=mesh)

    def _multi(self, ctx) -> bool:
        """Whether ``ctx`` is a multi-shift context, which only a backend
        declaring ``multi_shift`` may be handed (halo and allgather share
        the prepared state)."""
        if isinstance(ctx, MultiShiftGraphContext):
            require_capability(self, "multi_shift")
            return True
        return False

    def apply(self, filt, ctx, f, *, coeffs=None, overlap: bool | None = None, **_):
        _check_device(f, ctx.mesh.device)
        c = _coeffs_or(filt, coeffs)
        squeeze = f.ndim == 1
        if self._multi(ctx):
            # Per-shift halo exchange inside the joint recurrence (serial
            # exchange -> matvec; the overlapped schedule is single-shift).
            out = ctx.cheb_apply_joint(ctx.scatter_signal(f), c)
        else:
            out = ctx.cheb_apply(ctx.scatter_signal(f), c, filt.lmax, backend=self.name,
                                 overlap=overlap)
        out = ctx.gather_signal(out)
        return out[:, :, 0] if squeeze else out

    def adjoint(self, filt, ctx, a, **_):
        _check_device(a, ctx.mesh.device)
        squeeze = a.ndim == 2
        a3 = a[:, :, None] if squeeze else a
        sharded = ctx.scatter_signal(a3, vertex_dim=1)
        if self._multi(ctx):
            out = ctx.cheb_adjoint_joint(sharded, filt.coeffs)
        else:
            out = ctx.cheb_adjoint(sharded, filt.coeffs, filt.lmax)
        out = ctx.gather_signal(out)
        return out[:, 0] if squeeze else out

    def messages_per_apply(self, filt, ctx, matvec_counts) -> int:
        if self._multi(ctx):
            return ctx.messages_per_apply(matvec_counts)
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
    ``StackedMesh``). Both move exactly the same words.

    Multi-shift filters run here too: ``prepare`` builds one plan per
    shift over a shared union layout and the joint recurrence exchanges
    each shift's own halo (serial schedule), so ``messages_per_apply`` is
    the per-shift sum ``sum_r count_r * halo_words_r``.
    """

    name = "halo"
    capabilities = BackendCapabilities(multi_shift=True)


@register_backend
class AllgatherBackend(_ShardedBackendBase):
    """Naive distributed baseline: all-gather the full signal per order.

    Words per apply = ``M * n_local * P * (P-1)``. Its adjoint runs the
    halo exchange, as the reference's does. Single-shift only: it shares
    the ``partition_plan`` state with ``halo``, and ``GraphFilter``
    refuses a multi-shift filter at dispatch, before any ``prepare``.
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
