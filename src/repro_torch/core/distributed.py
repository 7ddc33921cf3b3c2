"""Distributed application of Chebyshev-approximated operators (paper Sec. IV).

Mirrors ``repro/core/distributed.py``: Algorithm 1 over P ranks. Vertices are partitioned across ranks; every Chebyshev order
exchanges **only partition-boundary vertex values** (the halo), the mesh
analog of the paper's "transmit (Tbar_{k-1}(L) f)_n to all neighbours".

* ``halo``      — precomputed halo exchange via ``all_to_all``: rank p
  sends rank q exactly the values of p's vertices that q's rows of L
  touch. Words per order = ``sum_{p,q} |boundary(p,q)|`` (<= 2|E|).
* ``allgather`` — naive baseline: all-gather the full signal every order.
* the overlapped halo schedule (:func:`halo_cheb_apply_overlapped`, the
  default on a process group): boundary rows of ``T_k`` first, then the exchange that step
  k+1 consumes (issued asynchronously on a process group), then the
  interior rows while it is in flight.
* the grid schedules: a matrix-free stencil on row slabs
  (:func:`grid_slab_matvec`) and the depth-d communication-avoiding
  recurrence (:func:`grid_cheb_apply_ca`).
* multi-shift joint filters (:class:`MultiShiftGraphContext`): one plan
  per shift over one shared vertex layout
  (:func:`build_shift_partition_plans`); each shift's matvec exchanges
  its own halo, on the serial schedule.

The collectives come from :mod:`repro_torch.core.collectives`: every
per-rank tensor carries a leading rank axis (P on a ``StackedMesh``, 1 in
a ``GroupMesh``), and the local products are batched matmuls over it.

The partition plan is built on the host in float64 numpy exactly as the
reference builds it, so every table equals the reference's bit for bit;
the tables then live on the plan's device. ``repair_partition_plan``
patches a plan after a topology delta the same way, on the host, and
puts the repaired tables back on the plan's device.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import chebyshev
from repro_torch.core import graph as graph_lib
from repro_torch.device import resolve_device

__all__ = [
    "PartitionPlan",
    "build_partition_plan",
    "build_shift_partition_plans",
    "repair_partition_plan",
    "plan_row_slabs",
    "halo_matvec",
    "halo_cheb_apply_overlapped",
    "allgather_matvec",
    "DistributedGraphContext",
    "MultiShiftGraphContext",
    "grid_slab_matvec",
    "grid_allgather_matvec",
    "grid_cheb_apply_ca",
]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Host-built static partition of a graph over ``n_parts`` ranks.

    The tables have a leading rank axis of size P and live on one device.

    Attributes:
      order: (N,) host vertex permutation; rank p owns slots
        ``[p*n_local, (p+1)*n_local)`` of the *permuted* order (padding
        slots past N are isolated dummy vertices).
      l_own: (P, n_local, n_local) diagonal Laplacian blocks (own-own).
      l_halo: (P, n_local, P*max_halo) off-diagonal rows, columns indexed
        by the *received* halo buffer layout (slot q*max_halo + i = i-th
        value received from rank q).
      send_idx: (P, P, max_halo) int64 local indices each rank sends to
        each other rank (padded with 0; receivers only read used columns).
      halo_words: true (unpadded) scalar words exchanged per matvec across
        all ranks — the paper's message-count analog.
      n_local: vertices per rank (padded).
      n: true number of vertices.
      n_boundary: uniform boundary-block size (clamped >= 1): local rows
        are ordered boundary-first, so rows ``[0, boundary_counts[p])``
        are exactly those with an off-partition column, and every
        ``send_idx`` entry lands below ``n_boundary``.
      boundary_counts: (P,) host true per-partition boundary-row counts.
      pair_counts: (P, P) host used-lane counts; ``pair_counts[p, q]``
        values travel from q to p per matvec (``halo_words`` is the sum).
    """

    order: np.ndarray
    l_own: torch.Tensor
    l_halo: torch.Tensor
    send_idx: torch.Tensor
    halo_words: int
    n_local: int
    n: int
    n_boundary: int = 1
    boundary_counts: np.ndarray | None = None
    pair_counts: np.ndarray | None = None

    @property
    def n_parts(self) -> int:
        return self.l_own.shape[0]

    @property
    def max_halo(self) -> int:
        return self.send_idx.shape[-1]

    def owner_of(self) -> np.ndarray:
        """(N,) partition owning each *original* (unpermuted) vertex."""
        inv = np.empty(self.n, dtype=np.int64)
        inv[self.order[: self.n]] = np.arange(self.n)
        return inv // self.n_local

    def vertex_send_counts(self, adjacency) -> np.ndarray:
        """(N,) per-vertex halo fan-out: how many *other* partitions each
        vertex is sent to per matvec (summing it gives ``halo_words``)."""
        a = _host(adjacency) != 0.0
        owner = self.owner_of()
        counts = np.zeros(self.n, dtype=np.int64)
        for p in range(self.n_parts):
            has_nbr_in_p = a[:, owner == p].any(axis=1)
            counts += (has_nbr_in_p & (owner != p)).astype(np.int64)
        return counts

    def delta_halo_words(self, adjacency, support, order: int, *, counts=None) -> int:
        """Halo words for one delta apply of a signal supported on ``S``:
        ``sum_{k=0}^{M-1} sum_{v in N_k(S)} send_counts[v]`` (reduces to
        ``order * halo_words`` at full support)."""
        if counts is None:
            counts = self.vertex_send_counts(adjacency)
        adjacency = _host(adjacency)
        mask = np.asarray(support, dtype=bool)
        words = 0
        for k in range(order):
            step_words = int(counts[mask].sum())
            words += step_words
            if mask.all():
                # Saturated: every remaining step costs the full halo.
                words += step_words * (order - 1 - k)
                break
            mask = graph_lib.khop_neighborhood(adjacency, mask, 1)
        return words


def _partition_layout(adjacency, coords, n_parts: int):
    """Spatial order + boundary-first refinement for one edge pattern.

    Returns ``(order, boundary_counts, n_local)`` — the final vertex
    permutation (refinement absorbed), the true per-partition boundary-row
    counts, and the padded per-rank slot count.
    """
    a = np.asarray(adjacency, dtype=np.float64)
    n = a.shape[0]
    if coords is not None:
        order = graph_lib.spatial_partition_order(np.asarray(coords), n_parts)
    else:
        order = np.arange(n)
    n_pad = ((n + n_parts - 1) // n_parts) * n_parts
    n_local = n_pad // n_parts

    # Permute-and-pad the Laplacian (padding vertices are isolated).
    lap = np.zeros((n_pad, n_pad))
    lp = np.diag(a.sum(axis=1)) - a
    lap[:n, :n] = lp[np.ix_(order, order)]

    # Boundary-first local refinement: within each partition, stably move
    # the rows with any off-partition column ahead of the interior rows.
    # L is symmetric, so every sent vertex is a boundary row and every
    # send_idx entry indexes the leading boundary block — the overlapped
    # schedule can exchange T_k as soon as that block is computed.
    boundary_counts = np.zeros(n_parts, dtype=np.int64)
    local_perm = np.empty(n_pad, dtype=np.int64)
    for p in range(n_parts):
        sl = slice(p * n_local, (p + 1) * n_local)
        rows = lap[sl]
        off_block = np.ones(n_pad, dtype=bool)
        off_block[sl] = False
        is_boundary = np.any(rows[:, off_block] != 0.0, axis=1)
        boundary_counts[p] = int(is_boundary.sum())
        local_perm[sl] = p * n_local + np.concatenate(
            [np.nonzero(is_boundary)[0], np.nonzero(~is_boundary)[0]])
    # Padding rows keep the global tail slots, so real vertices still
    # occupy local_perm[:n] and the public `order` absorbs the refinement.
    if not np.all(local_perm[:n] < n):
        raise AssertionError("padding rows left the global tail")
    return order[local_perm[:n]], boundary_counts, n_local


def _plan_tables(
    adjacency, order, boundary_counts, n_parts: int, n_local: int, dtype, device
) -> PartitionPlan:
    """Build a plan's halo tables for ``adjacency`` under a fixed layout."""
    a = np.asarray(adjacency, dtype=np.float64)
    n = a.shape[0]
    n_pad = n_local * n_parts

    lap = np.zeros((n_pad, n_pad))
    lp = np.diag(a.sum(axis=1)) - a
    lap[:n, :n] = lp[np.ix_(order, order)]
    n_boundary = max(1, int(boundary_counts.max()))

    owner = np.repeat(np.arange(n_parts), n_local)

    # For each ordered pair (p, q != p): vertices of q that p's rows touch.
    need: list[list[np.ndarray]] = [[None] * n_parts for _ in range(n_parts)]
    max_halo = 1
    for p in range(n_parts):
        rows = lap[p * n_local : (p + 1) * n_local]
        touched = np.nonzero(np.any(rows != 0.0, axis=0))[0]
        for q in range(n_parts):
            if q == p:
                continue
            t = touched[(owner[touched] == q)]
            need[p][q] = t
            max_halo = max(max_halo, len(t))

    send_idx = np.zeros((n_parts, n_parts, max_halo), dtype=np.int32)
    l_halo = np.zeros((n_parts, n_local, n_parts * max_halo))
    l_own = np.zeros((n_parts, n_local, n_local))
    pair_counts = np.zeros((n_parts, n_parts), dtype=np.int64)
    for p in range(n_parts):
        sl = slice(p * n_local, (p + 1) * n_local)
        l_own[p] = lap[sl, sl]
        for q in range(n_parts):
            if q == p:
                continue
            t = need[p][q]  # global ids owned by q, needed by p
            pair_counts[p, q] = len(t)
            # Sent vertices must sit in q's boundary block (symmetry).
            if not np.all(t - q * n_local < boundary_counts[q]):
                raise AssertionError(f"send lane outside the boundary block {(p, q)}")
            # q sends these to p: record in q's send table, destination p.
            send_idx[q, p, : len(t)] = t - q * n_local
            # p's halo columns for data received from q sit at block q.
            l_halo[p][:, q * max_halo : q * max_halo + len(t)] = lap[sl, t]

    return PartitionPlan(
        order=order,
        l_own=torch.as_tensor(l_own).to(device=device, dtype=dtype),
        l_halo=torch.as_tensor(l_halo).to(device=device, dtype=dtype),
        send_idx=torch.as_tensor(send_idx, dtype=torch.int64).to(device),
        halo_words=int(pair_counts.sum()),
        n_local=n_local,
        n=n,
        n_boundary=n_boundary,
        boundary_counts=boundary_counts,
        pair_counts=pair_counts,
    )


def build_partition_plan(
    adjacency,
    coords,
    n_parts: int,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> PartitionPlan:
    """Partition a graph spatially and precompute halo-exchange tables.

    ``adjacency`` and ``coords`` (tensors on any device, or arrays) are
    read on the host; the tables are placed on ``device`` (default
    ``cuda``).
    """
    dev = resolve_device(device)
    a = _host(adjacency)
    c = None if coords is None else _host(coords)
    order, boundary_counts, n_local = _partition_layout(a, c, n_parts)
    return _plan_tables(a, order, boundary_counts, n_parts, n_local, dtype, dev)


def build_shift_partition_plans(
    adjacencies,
    coords,
    n_parts: int,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> tuple[PartitionPlan, ...]:
    """Per-shift plans over ONE shared vertex layout.

    A joint recurrence interleaves matvecs in several shifts over the same
    signal, so every shift sees the vertices in the same order: one
    scatter, one gather, R exchange plans. The layout comes from the
    union edge pattern ``sum_r |A_r|``; each shift's tables are built
    under it, and each plan carries its own ``halo_words`` (0 for a shift
    whose edges never cross the cut). All plans share ``order``,
    ``n_local`` and ``boundary_counts``.
    """
    dev = resolve_device(device)
    mats = [_host(a).astype(np.float64) for a in adjacencies]
    if not mats:
        raise ValueError("need at least one adjacency")
    union = np.abs(mats[0])
    for m in mats[1:]:
        union = union + np.abs(m)
    c = None if coords is None else _host(coords)
    order, boundary_counts, n_local = _partition_layout(union, c, n_parts)
    return tuple(
        _plan_tables(a, order, boundary_counts, n_parts, n_local, dtype, dev) for a in mats
    )


def repair_partition_plan(
    plan: PartitionPlan, adjacency, touched, dtype: torch.dtype = torch.float32
) -> PartitionPlan:
    """Incrementally patch a plan after a topology delta (reference
    ``repair_partition_plan``, DESIGN.md Sec. 10).

    ``touched`` must contain BOTH endpoints of every changed edge (what
    ``GraphDelta.touched`` / ``apply_delta_inplace`` return); ``adjacency``
    is the NEW (N, N) matrix. The vertex->partition assignment is kept, so
    only the *dirty* partitions (owners of touched vertices) get new
    tables: a changed edge makes both endpoints touched, hence both owners
    dirty, so a clean partition kept every incident edge of every vertex
    it owns. Per pair: dirty p and dirty q recompute p's need set from q,
    q's send lanes and p's halo block from fresh rows; dirty p and clean q
    keep the values and lanes, row-permuted by p's new boundary-first
    order, and remap p's send table to q through the inverse permutation.
    ``n_boundary`` and ``max_halo`` only ever grow.

    The work is the reference's host numpy, on the old tables read through
    ``_host``, so every table equals the reference's repaired plan bit for
    bit; the repaired tables go back to the plan's own device.
    """
    if plan.boundary_counts is None:
        raise ValueError("repair requires a plan built with boundary_counts")
    touched = np.unique(np.asarray(touched, dtype=np.int64))
    if touched.size == 0:
        return plan
    a = _host(adjacency)
    n, n_local, n_parts = plan.n, plan.n_local, plan.n_parts
    n_pad = n_local * n_parts
    old_l_own = _host(plan.l_own)
    old_l_halo = _host(plan.l_halo)
    old_send = _host(plan.send_idx)
    max_halo = old_send.shape[-1]

    # Slot bookkeeping in the *current* plan order. Real vertices occupy
    # slots [0, n) (the builder asserts it; re-asserted after the permute).
    ids = np.full(n_pad, -1, dtype=np.int64)
    ids[:n] = plan.order[:n]
    slot_of = np.empty(n, dtype=np.int64)
    slot_of[ids[:n]] = np.arange(n)
    owner_vert = slot_of // n_local  # partition owning each original id

    dirty = sorted(set(int(p) for p in np.unique(owner_vert[touched])))
    dirty_set = set(dirty)

    if plan.pair_counts is not None:
        pair_counts = np.asarray(plan.pair_counts).copy()
    else:
        # A plan without pair counts: recover the used lanes from the halo
        # tables' zero pattern.
        pair_counts = np.zeros((n_parts, n_parts), dtype=np.int64)
        for p in range(n_parts):
            for q in range(n_parts):
                if q == p:
                    continue
                cols = old_l_halo[p][:, q * max_halo : (q + 1) * max_halo]
                pair_counts[p, q] = int(np.any(cols != 0.0, axis=0).sum())

    # Fresh Laplacian rows and boundary split for every dirty partition.
    boundary_counts = np.asarray(plan.boundary_counts).copy()
    rows_new: dict[int, np.ndarray] = {}  # p -> (n_local, n) rows, OLD slot order
    perms: dict[int, np.ndarray] = {}
    for p in dirty:
        sl = slice(p * n_local, (p + 1) * n_local)
        ids_p = ids[sl]
        real = ids_p >= 0
        rp = ids_p[real]
        rows = np.zeros((n_local, n))
        rows[real] = -a[rp]
        rows[np.nonzero(real)[0], rp] = a[rp].sum(axis=1, dtype=np.float64)
        rows_new[p] = rows
        own_col = np.zeros(n, dtype=bool)
        own_col[rp] = True
        is_boundary = np.any(rows[:, ~own_col] != 0.0, axis=1)
        boundary_counts[p] = int(is_boundary.sum())
        # Stable boundary-first reorder of the CURRENT local order; padding
        # rows are all-zero, hence interior, and stay at the tail.
        perms[p] = np.concatenate(
            [np.nonzero(is_boundary)[0], np.nonzero(~is_boundary)[0]]
        )
    n_boundary = max(plan.n_boundary, 1, int(boundary_counts.max()))

    new_ids = ids.copy()
    for p, perm in perms.items():
        sl = slice(p * n_local, (p + 1) * n_local)
        new_ids[sl] = ids[sl][perm]
    if not np.all(new_ids[:n] >= 0):
        raise AssertionError("padding escaped the global tail")
    new_order = new_ids[:n]
    slot_new = np.empty(n, dtype=np.int64)
    slot_new[new_order] = np.arange(n)

    # Grow max_halo only if a dirty-dirty pair outgrew its lanes.
    colmasks = {p: np.any(rows_new[p] != 0.0, axis=0) for p in dirty}
    needed = max_halo
    for p in dirty:
        cand = np.nonzero(colmasks[p])[0]
        for q in dirty:
            if q != p:
                needed = max(needed, int((owner_vert[cand] == q).sum()))
    if needed > max_halo:
        l_halo = np.zeros((n_parts, n_local, n_parts * needed), old_l_halo.dtype)
        send_idx = np.zeros((n_parts, n_parts, needed), old_send.dtype)
        for p in range(n_parts):
            for q in range(n_parts):
                if q == p:
                    continue
                cnt = int(pair_counts[p, q])
                l_halo[p][:, q * needed : q * needed + cnt] = old_l_halo[p][
                    :, q * max_halo : q * max_halo + cnt
                ]
                send_idx[q, p, :cnt] = old_send[q, p, :cnt]
        old_l_halo, old_send, max_halo = l_halo, send_idx, needed

    l_own = old_l_own.copy()
    l_halo = old_l_halo.copy()
    send_idx = old_send.copy()

    for p in dirty:
        perm = perms[p]
        inv = np.empty(n_local, dtype=np.int64)
        inv[perm] = np.arange(n_local)
        rows_p = rows_new[p][perm]  # rows in p's NEW local order
        ids_p_new = new_ids[p * n_local : (p + 1) * n_local]
        real = ids_p_new >= 0
        blk = np.zeros((n_local, n_local))
        blk[:, real] = rows_p[:, ids_p_new[real]]
        l_own[p] = blk
        cand = np.nonzero(colmasks[p])[0]
        for q in range(n_parts):
            if q == p:
                continue
            if q in dirty_set:
                t = cand[owner_vert[cand] == q]
                t = t[np.argsort(slot_new[t], kind="stable")]
                cnt = len(t)
                lanes = slot_new[t] - q * n_local
                if not np.all(lanes < boundary_counts[q]):
                    raise AssertionError(f"send lane outside the boundary block {(p, q)}")
                block = np.zeros((n_local, max_halo), l_halo.dtype)
                block[:, :cnt] = rows_p[:, t]
                l_halo[p][:, q * max_halo : (q + 1) * max_halo] = block
                lane_tbl = np.zeros(max_halo, send_idx.dtype)
                lane_tbl[:cnt] = lanes
                send_idx[q, p] = lane_tbl
                pair_counts[p, q] = cnt
            else:
                # Clean q: identical values and lanes; rows follow p's permute.
                l_halo[p][:, q * max_halo : (q + 1) * max_halo] = old_l_halo[p][
                    perm, q * max_halo : (q + 1) * max_halo
                ]
                cnt = int(pair_counts[q, p])  # lanes q reads from p
                lane_tbl = np.zeros(max_halo, send_idx.dtype)
                lane_tbl[:cnt] = inv[old_send[p, q, :cnt]]
                if not np.all(lane_tbl[:cnt] < boundary_counts[p]):
                    raise AssertionError(f"send lane outside the boundary block {(p, q)}")
                send_idx[p, q] = lane_tbl

    dev = plan.l_own.device
    return PartitionPlan(
        order=new_order,
        l_own=torch.as_tensor(l_own).to(device=dev, dtype=dtype),
        l_halo=torch.as_tensor(l_halo).to(device=dev, dtype=dtype),
        send_idx=torch.as_tensor(send_idx, dtype=torch.int64).to(dev),
        halo_words=int(pair_counts.sum()),
        n_local=n_local,
        n=n,
        n_boundary=n_boundary,
        boundary_counts=boundary_counts,
        pair_counts=pair_counts,
    )


def plan_row_slabs(plan: PartitionPlan) -> torch.Tensor:
    """Reassemble (P, n_local, N_pad) full row-slabs (allgather backend),
    on the host from the plan's tables, as the reference does."""
    n_parts, n_local, max_halo = plan.n_parts, plan.n_local, plan.max_halo
    rows = np.zeros((n_parts, n_local, n_parts * n_local), dtype=np.float32)
    l_own = _host(plan.l_own)
    l_halo = _host(plan.l_halo)
    send_idx = _host(plan.send_idx)
    for p in range(n_parts):
        sl = slice(p * n_local, (p + 1) * n_local)
        rows[p][:, sl] = l_own[p]
        for q in range(n_parts):
            if q == p:
                continue
            cols = l_halo[p][:, q * max_halo : (q + 1) * max_halo]
            used = np.any(cols != 0.0, axis=0)
            idx = send_idx[q, p][used] + q * n_local
            rows[p][:, idx] = cols[:, used]
    return torch.as_tensor(rows).to(plan.l_own.device)


# ---- the halo and allgather schedules ------------------------------------


def _send_rows(x: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """(R, n, T) rows picked per destination: (R, P, max_halo, T)."""
    ranks = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[ranks, send_idx]


def halo_matvec(x, l_own, l_halo, send_idx, mesh):
    """One distributed ``L @ x`` with halo exchange.

    Args:
      x: (R, n_local, ...) the local ranks' signal slices (any trailing
        dims: the adjoint passes (R, n_local, F, eta)).
      l_own: (R, n_local, n_local); l_halo: (R, n_local, P*max_halo);
      send_idx: (R, P, max_halo) — the local ranks' plan tables.
      mesh: a ``StackedMesh`` or ``GroupMesh``.
    """
    r, n_local = x.shape[:2]
    x2 = x.reshape(r, n_local, -1)
    recv = mesh.all_to_all(_send_rows(x2, send_idx))
    halo = recv.reshape(r, -1, x2.shape[-1])  # (R, P*max_halo, T)
    out = torch.bmm(l_own, x2) + torch.bmm(l_halo, halo)
    return out.reshape(x.shape)


def halo_cheb_apply_overlapped(
    f_loc,
    coeffs,
    lmax,
    l_own,
    l_halo,
    send_idx,
    *,
    n_boundary: int,
    mesh,
):
    """Overlapped distributed ``Phi~ f``.

    Same recurrence and combine as ``chebyshev.cheb_apply`` over
    :func:`halo_matvec`, restructured so communication hides behind
    computation. Step k

    1. computes only the boundary rows of ``T_k`` (they need the full
       ``T_{k-1}`` and its halo, both on hand from step k-1),
    2. issues the ``all_to_all`` producing the halo step k+1 consumes
       (``async_op=True``; waited on when step k+1 starts),
    3. computes the interior rows of ``T_k`` while it is in flight.

    The final step is peeled with no exchange (``T_M``'s halo is never
    consumed), so exactly M exchanges run per apply.

    Args:
      f_loc: (R, n_local, ...) the local ranks' signal slices.
      coeffs: (eta, M+1) union coefficients; lmax: spectrum bound.
      l_own/l_halo/send_idx: the local ranks' plan tables.
      n_boundary: uniform boundary-block size from the plan.

    Returns: (eta,) + f_loc.shape combined outputs.
    """
    b = n_boundary
    coeffs = chebyshev._cast_coeffs(coeffs, f_loc)
    alpha = chebyshev._alpha(lmax, f_loc)
    order = coeffs.shape[1] - 1
    r, n_local = f_loc.shape[:2]
    f2 = f_loc.reshape(r, n_local, -1)
    width = f2.shape[-1]
    own = (l_own[:, :b], l_own[:, b:])
    hal = (l_halo[:, :b], l_halo[:, b:])

    def exchange(t_boundary):
        """Issue the all_to_all for one Krylov vector's boundary block."""
        return mesh.all_to_all(_send_rows(t_boundary, send_idx), async_op=True)

    def step_rows(part, rows, t1, t0, halo1, first):
        """Rows ``rows`` of T_k from full T_{k-1}, T_{k-2} and T_{k-1}'s
        halo — the same shifted recurrence as ``chebyshev.cheb_apply``."""
        lx = torch.bmm(own[part], t1) + torch.bmm(hal[part], halo1)
        if first:
            return (lx - alpha * t1[:, rows]) / alpha
        return (2.0 / alpha) * (lx - alpha * t1[:, rows]) - t0[:, rows]

    def overlapped_step(t1, t0, pending, first, with_exchange):
        """Wait for T_{k-1}'s halo -> boundary rows -> issue exchange ->
        interior rows."""
        halo1 = pending.wait().reshape(r, -1, width)
        tk_b = step_rows(0, slice(0, b), t1, t0, halo1, first)
        pending_k = exchange(tk_b) if with_exchange else None
        tk_i = step_rows(1, slice(b, None), t1, t0, halo1, first)
        return torch.cat([tk_b, tk_i], dim=1), pending_k

    t0 = f2
    pending = exchange(t0[:, :b])  # T0's boundary values for step 1
    t1, pending = overlapped_step(t0, t0, pending, first=True, with_exchange=order >= 2)
    acc = chebyshev._outer(0.5 * coeffs[:, 0], t0) + chebyshev._outer(coeffs[:, 1], t1)
    if order >= 2:
        for k in range(2, order):
            tk, pending_k = overlapped_step(t1, t0, pending, first=False, with_exchange=True)
            acc = acc + chebyshev._outer(coeffs[:, k], tk)
            t1, t0, pending = tk, t1, pending_k
        # Peeled last step: T_M feeds only the combine, never an exchange.
        tk, _ = overlapped_step(t1, t0, pending, first=False, with_exchange=False)
        acc = acc + chebyshev._outer(coeffs[:, order], tk)
    return acc.reshape((coeffs.shape[0],) + f_loc.shape)


def allgather_matvec(x, l_rows, mesh):
    """Naive baseline: all-gather the full signal, multiply own row-slab.

    x: (R, n_local, ...); l_rows: (R, n_local, P*n_local)."""
    r, n_local = x.shape[:2]
    x_full = mesh.all_gather(x.reshape(r, n_local, -1))
    return torch.bmm(l_rows, x_full).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class DistributedGraphContext:
    """Binds a PartitionPlan to a mesh and exposes distributed ops.

    Signals in the *sharded* layout are the local ranks' slabs of the
    permuted, padded signal: ``(R * n_local, F)``, which on a
    ``StackedMesh`` is the whole ``(P * n_local, F)`` array of the
    reference. The local ranks' tables, the allgather row slabs and the
    scatter/gather index tensors are built on first use and cached in
    ``_cache``; coefficients and ``lmax`` enter as call arguments.
    """

    plan: PartitionPlan
    mesh: object
    _cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if self.plan.n_parts != self.mesh.n_parts:
            raise ValueError(
                f"plan has {self.plan.n_parts} parts, the mesh {self.mesh.n_parts} ranks"
            )
        if self.plan.l_own.device != self.mesh.device:
            raise ValueError(
                f"plan tables on {self.plan.l_own.device}, the mesh on {self.mesh.device}"
            )

    # -- layout ----------------------------------------------------------

    def _cached(self, key, build):
        value = self._cache.get(key)
        if value is None:
            value = self._cache[key] = build()
        return value

    def _tables(self):
        """The local ranks' (l_own, l_halo, send_idx)."""
        p = self.plan
        return self._cached("tables", lambda: tuple(
            self.mesh.local_rows(t) for t in (p.l_own, p.l_halo, p.send_idx)))

    def _halo_matvec(self):
        l_own, l_halo, send_idx = self._tables()
        return partial(halo_matvec, l_own=l_own, l_halo=l_halo, send_idx=send_idx,
                       mesh=self.mesh)

    def _index(self, name: str) -> torch.Tensor:
        def build():
            order = self.plan.order
            if name == "order":
                return torch.as_tensor(order, device=self.mesh.device)
            inv = np.empty_like(order)
            inv[order] = np.arange(self.plan.n)
            return torch.as_tensor(inv, device=self.mesh.device)

        return self._cached(name, build)

    def scatter_signal(self, f: torch.Tensor, *, vertex_dim: int = 0) -> torch.Tensor:
        """Permute and pad a global signal along ``vertex_dim`` and keep
        the local ranks' slabs: (N,) or (N, F) -> (R * n_local, F); with
        ``vertex_dim=1``, (eta, N, F) -> (eta, R * n_local, F)."""
        plan = self.plan
        if vertex_dim == 0 and f.ndim == 1:
            f = f[:, None]
        fp = torch.index_select(f, vertex_dim, self._index("order"))
        pad = plan.n_local * plan.n_parts - plan.n
        pad_spec = [0, 0] * (fp.ndim - 1 - vertex_dim) + [0, pad]
        fp = F.pad(fp, pad_spec)
        slabs = fp.unflatten(vertex_dim, (plan.n_parts, plan.n_local))
        return self.mesh.local_rows(slabs, vertex_dim).flatten(vertex_dim, vertex_dim + 1)

    def gather_signal(self, y: torch.Tensor) -> torch.Tensor:
        """Invert scatter: (..., R * n_local, F) -> (..., N, F) in input
        order, on every rank."""
        slabs = y.unflatten(-2, (-1, self.plan.n_local))
        full = self.mesh.gather_ranks(slabs, slabs.ndim - 3).flatten(-3, -2)
        return torch.index_select(full, -2, self._index("inv"))

    def _local(self, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """(.., R * n_local, ...) -> (.., R, n_local, ...)."""
        return x.unflatten(lead, (-1, self.plan.n_local))

    # -- the schedules ---------------------------------------------------

    def cheb_apply(self, f_sharded, coeffs, lmax, backend: str = "halo",
                   overlap: bool | None = None):
        """Distributed ``Phi~ f`` (Algorithm 1 on the mesh).

        f_sharded: (R * n_local, F) from :meth:`scatter_signal`.
        overlap: halo backend only — the overlapped schedule (True) or
          the serial exchange->matvec one (False); same results up to f32
          rounding, same message count. ``None`` takes ``mesh.overlaps``:
          overlapped only where an exchange can be in flight (a process
          group), serial on a ``StackedMesh``, whose exchange is a
          transpose on the compute stream.
        Returns (eta, R * n_local, F).
        """
        f_loc = self._local(f_sharded)
        if backend == "halo":
            if self.mesh.overlaps if overlap is None else overlap:
                l_own, l_halo, send_idx = self._tables()
                out = halo_cheb_apply_overlapped(
                    f_loc, coeffs, lmax, l_own, l_halo, send_idx,
                    n_boundary=self.plan.n_boundary, mesh=self.mesh)
            else:
                out = chebyshev.cheb_apply(self._halo_matvec(), f_loc, coeffs, lmax)
        elif backend == "allgather":
            l_rows = self._cached(
                "l_rows", lambda: self.mesh.local_rows(plan_row_slabs(self.plan)))
            mv = partial(allgather_matvec, l_rows=l_rows, mesh=self.mesh)
            out = chebyshev.cheb_apply(mv, f_loc, coeffs, lmax)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        return out.flatten(1, 2)

    def cheb_adjoint(self, a_sharded, coeffs, lmax):
        """Distributed ``Phi~* a`` (paper Sec. IV-B: length-eta messages).

        a_sharded: (eta, R * n_local, F). Returns (R * n_local, F)."""
        out = chebyshev.cheb_adjoint_apply(self._halo_matvec(), self._local(a_sharded, 1),
                                           coeffs, lmax)
        return out.flatten(0, 1)

    def messages_per_apply(self, order: int, backend: str = "halo") -> int:
        """Scalar words moved per ``Phi~ f`` of one (N,) signal (padding
        excluded): ``halo`` ``M * halo_words`` (<= 2M|E|, the paper's
        radio bound), ``allgather`` ``M * n_local * P * (P - 1)``."""
        if backend == "halo":
            return order * self.plan.halo_words
        n_dev = self.plan.n_parts
        return order * self.plan.n_local * n_dev * (n_dev - 1)


@dataclasses.dataclass(frozen=True)
class MultiShiftGraphContext:
    """Distributed context of a multi-shift joint filter: R per-shift
    :class:`PartitionPlan` s over one shared layout
    (:func:`build_shift_partition_plans`), bound to a mesh.

    One scatter and one gather move the signal; inside the joint
    recurrence every matvec of shift r runs :func:`halo_matvec` on
    ``plans[r]`` (the serial schedule; the overlapped one stays
    single-shift, as in the reference), so it moves exactly
    ``plans[r].halo_words`` words.
    """

    plans: tuple[PartitionPlan, ...]
    mesh: object
    lmaxes: tuple[float, ...]
    _contexts: tuple = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if len(self.plans) != len(self.lmaxes):
            raise ValueError(f"{len(self.plans)} plans for {len(self.lmaxes)} lmaxes")
        ctxs = tuple(DistributedGraphContext(plan=p, mesh=self.mesh) for p in self.plans)
        object.__setattr__(self, "_contexts", ctxs)

    @property
    def plan(self) -> PartitionPlan:
        """The first shift's plan: the layout fields (order, n_local, n)
        are shared by construction."""
        return self.plans[0]

    def scatter_signal(self, f: torch.Tensor, *, vertex_dim: int = 0) -> torch.Tensor:
        """As :meth:`DistributedGraphContext.scatter_signal` (shared layout)."""
        return self._contexts[0].scatter_signal(f, vertex_dim=vertex_dim)

    def gather_signal(self, y: torch.Tensor) -> torch.Tensor:
        """As :meth:`DistributedGraphContext.gather_signal` (shared layout)."""
        return self._contexts[0].gather_signal(y)

    def _matvecs(self):
        return [ctx._halo_matvec() for ctx in self._contexts]

    def cheb_apply_joint(self, f_sharded, coeffs):
        """Distributed joint ``Phi~ f``: f_sharded (R * n_local, F) from
        :meth:`scatter_signal`, coeffs (eta, M_1+1, ..., M_R+1). Returns
        (eta, R * n_local, F)."""
        f_loc = self._contexts[0]._local(f_sharded)
        out = chebyshev.cheb_apply_joint(self._matvecs(), f_loc, coeffs, self.lmaxes)
        return out.flatten(1, 2)

    def cheb_adjoint_joint(self, a_sharded, coeffs):
        """Distributed joint ``Phi~* a``: a_sharded (eta, R * n_local, F).
        Returns (R * n_local, F)."""
        a_loc = self._contexts[0]._local(a_sharded, 1)
        out = chebyshev.cheb_adjoint_apply_joint(self._matvecs(), a_loc, coeffs, self.lmaxes)
        return out.flatten(0, 1)

    def messages_per_apply(self, matvec_counts) -> int:
        """Per-shift words: shift r's ``count_r`` matvecs each move its own
        plan's ``halo_words``."""
        return int(sum(int(c) * p.halo_words for c, p in zip(matvec_counts, self.plans)))


# ---- the grid schedules: matrix-free stencil on row slabs -----------------


def _grid_degree(gr: torch.Tensor, side: int, dtype) -> torch.Tensor:
    """(R, rows, side) stencil degrees of the non-periodic grid for global
    row ids ``gr`` (R, rows)."""
    col = torch.arange(side, device=gr.device)
    col_deg = ((col == 0).to(dtype) + (col == side - 1).to(dtype))[None, None, :]
    return (4.0 - (gr == 0).to(dtype)[..., None] - (gr == side - 1).to(dtype)[..., None]
            - col_deg)


def _left_right(x3: torch.Tensor):
    """Left and right neighbours along the column axis (dim 2), zero
    outside the grid."""
    return F.pad(x3[:, :, :-1], (0, 0, 1, 0)), F.pad(x3[:, :, 1:], (0, 0, 0, 1))


def grid_slab_matvec(x_local, *, side: int, mesh):
    """``L @ x`` for a non-periodic 4-neighbour unit-weight grid, one
    row-slab per rank; x_local: (R, rows_per * side, ...).

    Communication: 2 shifts of one (side, ...) boundary row.
    """
    r = x_local.shape[0]
    rows_per = x_local.shape[1] // side
    x3 = x_local.reshape(r, rows_per, side, -1)
    # neighbour-above's last row / neighbour-below's first row (zeros at
    # the global boundary: the shift delivers 0 where no sender exists).
    halo_up = mesh.shift_fwd(x3[:, -1])
    halo_dn = mesh.shift_bwd(x3[:, 0])
    up = torch.cat([halo_up[:, None], x3[:, :-1]], dim=1)
    dn = torch.cat([x3[:, 1:], halo_dn[:, None]], dim=1)
    left, right = _left_right(x3)
    gr = mesh.rank_index()[:, None] * rows_per + torch.arange(rows_per, device=x3.device)
    deg = _grid_degree(gr, side, x3.dtype)
    y = deg[..., None] * x3 - up - dn - left - right
    return y.reshape(x_local.shape)


def grid_allgather_matvec(x_local, *, side: int, mesh):
    """Naive baseline: all-gather the full field, stencil on the slab."""
    r = x_local.shape[0]
    rows_per = x_local.shape[1] // side
    full3 = mesh.all_gather(x_local.reshape(r, rows_per * side, -1)).reshape(r, side, side, -1)
    padded = F.pad(full3, (0, 0, 0, 0, 1, 1))
    gr = mesh.rank_index()[:, None] * rows_per + torch.arange(rows_per, device=full3.device)
    ranks = torch.arange(r, device=full3.device)[:, None]
    x3, up, dn = full3[ranks, gr], padded[ranks, gr], padded[ranks, gr + 2]
    left, right = _left_right(x3)
    y = _grid_degree(gr, side, x3.dtype)[..., None] * x3 - up - dn - left - right
    return y.reshape(x_local.shape)


def grid_cheb_apply_ca(f_local, coeffs, lmax, *, side: int, mesh, depth: int = 2):
    """Communication-avoiding Chebyshev application on the grid slabs.

    Instead of one boundary-row exchange per order, exchange a
    ``depth``-row halo once and run ``depth`` recurrence steps locally on
    the extended slab. Neighbour rounds per apply (one round = one shift
    each way): 1 for ``T_1`` plus ``ceil((M - 1) / depth)`` blocks, so
    ``2 + 2 * ceil((M - 1) / depth)`` shift calls for M >= 2. Each block
    packs ``T_{k-1}`` and ``T_{k-2}`` into one message per direction.

    Ghost rows outside the global grid are re-zeroed after every local
    step, which with the boundary-degree stencil reproduces the
    non-periodic Laplacian exactly. Requires ``depth <= rows-per-slab``.

    f_local: (R, rows_per * side, ...). Returns (eta,) + f_local.shape.
    """
    r = f_local.shape[0]
    rows_per = f_local.shape[1] // side
    if not 1 <= depth <= rows_per:
        raise ValueError(f"depth={depth} outside [1, rows per slab={rows_per}]")
    coeffs = chebyshev._cast_coeffs(coeffs, f_local)
    eta, m_plus1 = coeffs.shape
    order = m_plus1 - 1
    alpha = chebyshev._alpha(lmax, f_local)
    dt, dev = f_local.dtype, f_local.device

    def cw(k):  # coefficient column k, broadcast over (R, rows, side, T)
        return coeffs[:, k, None, None, None, None]

    def local_step(t1e, t0e, gr_ext):
        """One recurrence step on an extended slab (loses 1 ghost row per
        side). t1e/t0e: (R, R_ext, side, T); returns (R, R_ext-2, side, T)."""
        deg = _grid_degree(gr_ext, side, dt)
        up, dn, mid = t1e[:, :-2], t1e[:, 2:], t1e[:, 1:-1]
        left, right = _left_right(mid)
        lx = deg[:, 1:-1, :, None] * mid - up - dn - left - right
        t_new = (2.0 / alpha) * (lx - alpha * mid) - t0e[:, 1:-1]
        # zero rows outside the global domain (non-periodic boundary)
        valid = (gr_ext[:, 1:-1] >= 0) & (gr_ext[:, 1:-1] < side)
        return t_new * valid[:, :, None, None].to(dt)

    def exchange(t, d):
        """Extend a (R, rows_per, side, T) slab with d ghost rows per side."""
        top_halo = mesh.shift_fwd(t[:, -d:])  # from above
        bot_halo = mesh.shift_bwd(t[:, :d])  # from below
        return torch.cat([top_halo, t, bot_halo], dim=1)

    f3 = f_local.reshape(r, rows_per, side, -1)
    gr_base = mesh.rank_index()[:, None] * rows_per + torch.arange(rows_per, device=dev)

    # T0 = f ; T1 = (L - aI) f / a  (one depth-1 exchange)
    t0 = f3
    t0e = exchange(t0, 1)
    left, right = _left_right(t0)
    lx = (_grid_degree(gr_base, side, dt)[..., None] * t0 - t0e[:, :-2] - t0e[:, 2:]
          - left - right)
    t1 = lx / alpha - t0
    acc = 0.5 * cw(0) * t0[None] + cw(1) * t1[None]

    # Remaining orders in blocks of `depth`: each block's ghost exchange
    # is issued before the previous block's deferred eta-combines.
    def exchange_block(t1, t0, d):
        # pack the T_{k-1} (depth d) and T_{k-2} (depth d-1, padded to d)
        # ghosts into ONE neighbour message per direction.
        packed = torch.stack([t1, t0], dim=1)  # (R, 2, rows_per, side, T)
        top_halo = mesh.shift_fwd(packed[:, :, -d:])
        bot_halo = mesh.shift_bwd(packed[:, :, :d])
        return torch.cat([top_halo, packed, bot_halo], dim=2)

    k = 2
    if k <= order:
        ext = exchange_block(t1, t0, min(depth, order - k + 1))
    while k <= order:
        d = min(depth, order - k + 1)
        t1e, t0e = ext[:, 0], ext[:, 1]
        gr_ext = torch.cat([gr_base[:, :1] + torch.arange(-d, 0, device=dev), gr_base,
                            gr_base[:, -1:] + torch.arange(1, d + 1, device=dev)], dim=1)
        interiors = []
        for j in range(d):
            t_new_ext = local_step(t1e, t0e, gr_ext)
            # shrink: t0 <- t1 (trimmed), t1 <- t_new
            t0e, t1e, gr_ext = t1e[:, 1:-1], t_new_ext, gr_ext[:, 1:-1]
            trim = d - j - 1
            interiors.append(t_new_ext[:, trim: t_new_ext.shape[1] - trim]
                             if trim else t_new_ext)
        # after d steps both t1e and t0e are ghost-free (R, rows_per, ...)
        t0, t1 = t0e, t1e
        k_block = k
        k += d
        if k <= order:
            # issue the next block's exchange first, combine while it flies
            ext = exchange_block(t1, t0, min(depth, order - k + 1))
        for j, interior in enumerate(interiors):
            acc = acc + cw(k_block + j) * interior[None]
    return acc.reshape((eta,) + f_local.shape)
