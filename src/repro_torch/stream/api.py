"""``StreamingFilter`` — stateful delta filtering across signal frames.

Mirrors ``repro/stream/api.py``. Linearity is the whole trick (DESIGN.md
Sec. 8): with ``delta_t = f_t - f_{t-1}``,

    ``Phi~ f_t = Phi~ f_{t-1} + Phi~ delta_t``

and when ``delta_t`` is supported on a sparse changed set S, the degree-M
recurrence of ``Phi~ delta_t`` only touches the M-hop neighbourhood
``N_M(S)``, exactly. The stream caches the previous frame's input and
output, filters the delta on the induced submatrix through the backend's
``sparse_input`` capability, and accumulates.

Topology churn (DESIGN.md Sec. 10): ``push(frame, delta=GraphDelta(...))``
patches the Laplacian, re-certifies ``lmax`` incrementally
(``repro_torch.dynamic.LmaxTracker``), repairs the partition plan, and
corrects the cached output with the Krylov-difference recurrence, both
stages exact on the M-hop neighbourhood of the changed-edge endpoints. A
churn-active stream routes every later apply through its own dense and
restricted kernels (the shared ``GraphFilter`` still describes the
original graph and is never mutated).

Where the state lives. On the stream's device (the filter's graph's):
the last input ``_y``, the last output ``_out``, the (M+1, N, F) Krylov
stack ``_tk`` and, once churn is active, a copy of the Laplacian and the
float32 coefficients (uploaded once per coefficient change). On the
host, as in the reference, what host algorithms walk: the boolean
adjacency for the reach BFS, the float32 adjacency and Laplacian that
``apply_delta_inplace`` patches, the lmax tracker, and the partition plan
the words are counted on (built on the CPU: accounting only). Per frame
the (N,) changed mask comes down to the host, and the reach's indices and
the delta's entries (O(|reach| + |delta|)) go up; no (N, N) matrix and no
Krylov stack crosses. ``FrameResult.out`` is a tensor on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core import chebyshev
from repro_torch.core.distributed import (
    PartitionPlan,
    build_partition_plan,
    repair_partition_plan,
)
from repro_torch.device import resolve_device, upload
from repro_torch.dynamic.delta import (
    GraphDelta,
    LmaxTracker,
    apply_delta_inplace,
    churn_correction,
    dense_cheb_apply_krylov,
    restricted_cheb_apply_krylov,
)
from repro_torch.filters import GraphFilter, backend_supports_sparse, bucket_size, gather_reach
from repro_torch.telemetry import span

__all__ = ["FrameResult", "StreamingFilter"]


def stream_device(filt: GraphFilter, device) -> torch.device:
    """The device a stream (or a serving engine) over ``filt`` runs on:
    ``device=`` resolved (default ``cuda``, raising without it), which
    must be the device of the filter's bound graph."""
    dev = resolve_device(device)
    if filt.graph is not None and filt.graph.device != dev:
        raise ValueError(f"the filter's graph is on {filt.graph.device}, not on {dev}")
    return dev


def stream_frame(filt: GraphFilter, device: torch.device, frame) -> torch.Tensor:
    """A frame as a tensor on the stream's device: a host frame is placed
    on the bound graph's device as float32; a tensor on another device is
    refused (a stream never moves its state)."""
    y = filt._signal(frame)
    if y.device != device:
        raise ValueError(f"frame is on {y.device}, the stream on {device}")
    return y


@dataclasses.dataclass(frozen=True)
class FrameResult:
    """Outcome of one :meth:`StreamingFilter.push`.

    Attributes
    ----------
    out : torch.Tensor
        (eta,) + frame.shape filter output for this frame, on the stream's
        device (the full output, whichever path produced it).
    mode : str
        ``"full"`` (cold or above the delta threshold), ``"delta"``
        (sparse-support path), ``"churn"`` (topology delta corrected
        incrementally on the changed-edge neighbourhood), or ``"cached"``
        (frame identical to the previous one — no filtering at all).
    frame : int
        0-based frame index within the stream.
    changed : int
        Number of vertices whose value changed vs the previous frame.
    active : int
        Vertices the recurrence touched: ``|N_M(changed)|`` when a
        ``sparse_input`` backend restricted the delta apply, N when the
        whole graph was filtered, 0 on a cache hit.
    words : int
        Halo words this frame would exchange on the partitioned
        deployment the stream is accounting for (0 without a plan).
    latency_s : float
        Host-clock seconds spent in ``push``. On a CUDA stream this ends
        when the host has queued the frame's device work (a delta frame
        waits once, for the changed mask), not when the device finishes.
    edges_changed : int
        Edge weights that actually moved in this frame's topology delta
        (0 for pure signal frames).
    host_s : float
        Host-clock seconds of the push's host algorithms, part of
        ``latency_s``: the reach BFS and words walk, and on a topology
        delta the in-place patch, the lmax certificate and plan repair.
    """

    out: torch.Tensor
    mode: str
    frame: int
    changed: int
    active: int
    words: int
    latency_s: float
    edges_changed: int = 0
    host_s: float = 0.0


def _host_work(method):
    """Add a host algorithm's host-clock time to the push's ``host_s``,
    inside a ``stream.<method>`` span."""
    name = "stream." + method.__name__.lstrip("_")

    @functools.wraps(method)
    def timed(self, *args, **kwargs):
        with span(name):
            t0 = time.perf_counter()
            try:
                return method(self, *args, **kwargs)
            finally:
                self._host_s += time.perf_counter() - t0

    return timed


class StreamingFilter:
    """Carry filter state across frames; filter sparse deltas only.

    Parameters
    ----------
    filt : GraphFilter
        The filter to stream (bound to a graph for graph-bound backends).
    backend : str
        ``GraphFilter`` backend answering full refilters and, when it
        declares ``sparse_input`` (``dense`` does), the restricted delta
        applies. Backends without the capability stream correctly but pay
        a full apply per frame.
    max_delta_frac : float
        Delta-path threshold: above this fraction of changed vertices a
        full refilter runs. Default 0.25.
    atol : float
        Absolute tolerance deciding whether a vertex "changed"; 0.0 means
        exact comparison.
    refresh_every : int, optional
        Force a full refilter every k-th frame. None (default) never forces.
    n_parts : int, optional
        Build a partition plan over ``n_parts`` workers (on the CPU) and
        account halo words per frame against it. Accounting only:
        execution stays on ``backend``.
    opts : dict, optional
        Extra backend options forwarded to every apply.
    lmax_headroom : float
        Safety factor when churn pushes the certified ``lmax`` bound past
        the filter's domain and the coefficients are re-expanded from the
        multiplier bank. Default 1.25.
    device : str or torch.device, optional
        The stream's device, default ``cuda`` (raises without it); it must
        be the bound graph's device.
    """

    def __init__(
        self,
        filt: GraphFilter,
        *,
        backend: str = "dense",
        max_delta_frac: float = 0.25,
        atol: float = 0.0,
        refresh_every: int | None = None,
        n_parts: int | None = None,
        opts: dict | None = None,
        lmax_headroom: float = 1.25,
        device: str | torch.device | None = None,
    ):
        self.device = stream_device(filt, device)
        self.filt = filt
        self.backend = backend
        self.max_delta_frac = float(max_delta_frac)
        self.atol = float(atol)
        self.refresh_every = refresh_every
        self.opts = dict(opts or {})
        self.lmax_headroom = float(lmax_headroom)
        # The host boolean adjacency the per-frame BFS walks, read back
        # once per stream (churn replaces the stream's copy, never this).
        self._adj_bool0: np.ndarray | None = None
        if filt.graph is not None:
            self._adj_bool0 = filt.graph.adjacency.cpu().numpy() != 0.0
        self._plan0: PartitionPlan | None = None
        self._send_counts0: np.ndarray | None = None
        if n_parts is not None:
            if filt.graph is None:
                raise ValueError("words accounting (n_parts=) needs a bound graph")
            self._plan0 = build_partition_plan(
                filt.graph.adjacency, filt.graph.coords, n_parts, device="cpu"
            )
            self._send_counts0 = self._plan0.vertex_send_counts(self._adj_bool0)
        self.reset()

    def reset(self) -> None:
        """Drop all carried state; the next push is a cold full filter.

        Also drops any accumulated topology churn: the stream snaps back
        to ``filt.graph`` with the original partition plan, coefficients
        and ``lmax``.
        """
        self._y: torch.Tensor | None = None
        self._out: torch.Tensor | None = None
        self._host_s = 0.0
        self.frames = 0
        self.full_refilters = 0
        self.delta_frames = 0
        self.words_total = 0
        self._adj_bool = self._adj_bool0
        self._plan = self._plan0
        self._send_counts = None if self._send_counts0 is None else self._send_counts0.copy()
        self._owner: np.ndarray | None = (
            self._plan.owner_of() if self._plan is not None else None
        )
        # Churn state (lazily activated by the first topology delta).
        self._churn = False
        self._adj: np.ndarray | None = None
        self._lap: np.ndarray | None = None
        self._lap_dev: torch.Tensor | None = None
        self._coeffs: np.ndarray | None = None
        self._coeffs_dev: torch.Tensor | None = None
        self._lmax: float | None = None
        self._tracker: LmaxTracker | None = None
        self._tk: torch.Tensor | None = None  # (M+1, N, F) Krylov stack of _y
        self.churn_frames = 0
        self.reexpansions = 0
        self.graph_version = 0

    @property
    def recertifications(self) -> int:
        """Exact-bound recomputations the lmax tracker has performed."""
        return 0 if self._tracker is None else self._tracker.recertifications

    # -- topology churn ---------------------------------------------------

    def _activate_churn(self) -> None:
        """First topology delta: snapshot the graph into mutable host state
        and put the Laplacian and coefficients on the device (once)."""
        if self.filt.graph is None:
            raise ValueError("topology deltas need a graph-bound filter")
        self._adj = self.filt.graph.adjacency.cpu().numpy().astype(np.float32)
        self._lap = np.diag(self._adj.sum(axis=1)).astype(np.float32) - self._adj
        self._lap_dev = upload(self._lap, self.device)
        self._adj_bool = self._adj != 0.0
        self._set_coeffs(np.atleast_2d(np.asarray(self.filt.coeffs, np.float64)))
        self._lmax = float(self.filt.lmax)
        self._tracker = LmaxTracker(self._adj)
        self._churn = True

    def _set_coeffs(self, coeffs: np.ndarray) -> None:
        """Host float64 coefficients and their float32 device copy: one
        upload per coefficient change, not per frame."""
        self._coeffs = coeffs
        self._coeffs_dev = upload(coeffs.astype(np.float32), self.device)

    def _patch_lap_dev(self, changed) -> None:
        """Copy the host Laplacian's patched entries to the device copy:
        O(|delta|) values, bit-identical to the host's arithmetic."""
        uv = np.asarray([(u, v) for u, v, _ in changed], dtype=np.int64)
        rows = np.concatenate([uv[:, 0], uv[:, 1], uv[:, 0], uv[:, 1]])
        cols = np.concatenate([uv[:, 1], uv[:, 0], uv[:, 0], uv[:, 1]])
        flat = np.unique(rows * self._lap.shape[1] + cols)
        rows, cols = np.divmod(flat, self._lap.shape[1])
        self._lap_dev[upload(rows, self.device), upload(cols, self.device)] = upload(
            self._lap[rows, cols], self.device
        )

    @_host_work
    def _apply_topology(self, delta: GraphDelta):
        """Patch graph/Laplacian/plan/certificate; returns
        ``(touched, changed_edges, reexpanded)``."""
        if not self._churn:
            self._activate_churn()
        touched, changed = apply_delta_inplace(self._adj, self._lap, delta)
        if not changed:
            return touched, changed, False
        self._patch_lap_dev(changed)
        for u, v, _ in changed:
            nz = self._adj[u, v] != 0.0
            self._adj_bool[u, v] = self._adj_bool[v, u] = nz
        self.graph_version += 1
        reexpanded = False
        bound = self._tracker.update(self._adj, changed)
        if bound > self._lmax:
            # Cheap certificate degraded past the filter domain: tighten —
            # exact AM first, then the warm-started power iteration — and
            # only if the spectrum outgrew the domain, re-expand.
            bound = self._tracker.recertify(self._adj)
            if bound > self._lmax:
                bound = self._tracker.power_estimate(self._lap_dev)
            if bound > self._lmax:
                reexpanded = self._reexpand(bound)
        if self._plan is not None:
            self._plan = repair_partition_plan(self._plan, self._adj, touched)
            self._update_send_counts(touched)
        return touched, changed, reexpanded

    def _reexpand(self, bound: float) -> bool:
        """Re-expand coefficients on a larger domain (full-refilter frame)."""
        if self.filt.multipliers is None:
            raise RuntimeError(
                "churn pushed lambda_max past the filter domain "
                f"({bound:.4g} > {self._lmax:.4g}) and the filter has no "
                "multiplier bank to re-expand from; build it via "
                "from_multipliers or with more lmax headroom"
            )
        self._lmax = float(self.lmax_headroom * bound)
        self._set_coeffs(np.atleast_2d(chebyshev.cheb_coefficients(
            list(self.filt.multipliers), self.filt.order, self._lmax
        )))
        self.reexpansions += 1
        return True

    def _update_send_counts(self, touched: np.ndarray) -> None:
        """Incremental ``vertex_send_counts``: a vertex's fan-out depends
        only on its incident edges and their owners, and plan repair never
        reassigns owners, so only touched vertices can change."""
        if self._send_counts is None:
            return
        owner = self._owner
        for v in touched:
            nbrs = np.nonzero(self._adj_bool[v])[0]
            self._send_counts[v] = (
                len(set(owner[nbrs].tolist()) - {owner[v]}) if nbrs.size else 0
            )

    # -- words accounting -------------------------------------------------

    def _full_words(self) -> int:
        if self._plan is None:
            return 0
        return self.filt.order * self._plan.halo_words

    @_host_work
    def _walk_delta(self, changed: np.ndarray) -> tuple[int, np.ndarray | None]:
        """One incremental host BFS serving both consumers of the change set.

        Returns ``(words, reach)``: the delta-support halo words (the
        ``PartitionPlan.delta_halo_words`` model: step k of the recurrence
        exchanges only the active boundary of ``N_{k-1}(S)``) and the
        M-hop reach mask handed to ``apply_sparse``. Each hop expands only
        the vertices the previous hop reached (``N_{k+1}(S) = N_k(S) ∪
        nbrs(N_k(S) \\ N_{k-1}(S))``), which gives the reference's masks
        without re-reading every reached row each hop.
        """
        if self._adj_bool is None:
            return 0, None
        a = self._adj_bool
        counts = self._send_counts
        mask = changed.copy()
        frontier = mask
        words = 0
        order = self.filt.order
        for k in range(order):
            if counts is not None:
                step_words = int(counts[mask].sum())
                words += step_words
                if mask.all():
                    words += step_words * (order - 1 - k)
                    return words, mask
            elif mask.all():
                return 0, mask
            reached = a[frontier].any(axis=0)
            frontier = reached & ~mask
            mask = mask | reached
        return words, mask

    # -- the streaming lane ----------------------------------------------

    def _changed(self, sig_delta: torch.Tensor) -> np.ndarray:
        """(N,) host mask of the vertices whose value moved by more than
        ``atol`` (the frame's one readback)."""
        changed = sig_delta.abs() > self.atol
        if changed.ndim == 2:
            changed = changed.any(dim=1)
        return changed.cpu().numpy()

    def push(self, frame, *, delta: GraphDelta | None = None) -> FrameResult:
        """Answer one frame, reusing the previous frame's output.

        Args:
          frame: the (N,) or (N, F) signal frame (a tensor on the stream's
            device, or a host array).
          delta: optional topology changes since the previous frame
            (``repro_torch.dynamic.GraphDelta``). The Laplacian, plan and
            certificate are patched first, then the cached output is
            corrected: the incremental path when the Krylov stack is live,
            a full dense refilter otherwise.

        Returns a :class:`FrameResult`; ``result.out`` equals the full
        apply of ``frame`` on the *current* (post-delta) graph up to float
        tolerance, whichever path produced it.
        """
        t0 = time.perf_counter()
        self._host_s = 0.0
        y = stream_frame(self.filt, self.device, frame)
        idx = self.frames
        self.frames += 1

        edges_changed = 0
        touched = changed_edges = None
        reexpanded = False
        if delta is not None and len(delta):
            touched, changed_edges, reexpanded = self._apply_topology(delta)
            edges_changed = len(changed_edges)

        n_changed = y.shape[0]  # reported on the full path (cold: everything)
        force_full = (
            self._y is None
            or y.shape != self._y.shape
            or (self.refresh_every is not None and idx % self.refresh_every == 0)
        )
        if edges_changed:
            self.churn_frames += 1
            incremental = (
                not force_full
                and not reexpanded
                and self._tk is not None
                and backend_supports_sparse(self.backend)
            )
            if incremental:
                res = self._churn_frame(y, idx, touched, changed_edges, t0)
                if res is not None:
                    return res
            return self._full_frame(y, idx, n_changed, t0, edges_changed)
        if not force_full:
            sig_delta = y - self._y
            changed = self._changed(sig_delta)
            n_changed = int(changed.sum())
            if n_changed == 0:
                self._y = y.clone()
                return FrameResult(
                    out=self._out.clone(),
                    mode="cached",
                    frame=idx,
                    changed=0,
                    active=0,
                    words=0,
                    latency_s=time.perf_counter() - t0,
                    host_s=self._host_s,
                )
            if n_changed <= self.max_delta_frac * y.shape[0]:
                if self._churn:
                    # The shared GraphFilter still holds the original
                    # graph; churn-active streams answer from their own
                    # patched Laplacian and keep the Krylov stack current.
                    res = self._churn_signal_delta(y, idx, sig_delta, changed, n_changed, t0)
                    if res is not None:
                        return res
                    return self._full_frame(y, idx, n_changed, t0, 0)
                # The host BFS serves the words model (wanted iff a plan
                # was requested) and the reach mask (a sparse_input backend
                # restricts with it); when neither exists it is skipped.
                restricts = backend_supports_sparse(self.backend)
                if restricts or self._send_counts is not None:
                    words, reach = self._walk_delta(changed)
                else:
                    words, reach = 0, None
                d_out = self.filt.apply_sparse(
                    sig_delta, changed, backend=self.backend, reach=reach, **self.opts
                )
                self._out = self._out + d_out
                self._y = y.clone()
                self.delta_frames += 1
                self.words_total += words
                active = y.shape[0]
                if restricts and reach is not None:
                    active = int(reach.sum())
                return FrameResult(
                    out=self._out.clone(),
                    mode="delta",
                    frame=idx,
                    changed=n_changed,
                    active=active,
                    words=words,
                    latency_s=time.perf_counter() - t0,
                    host_s=self._host_s,
                )
        return self._full_frame(y, idx, n_changed, t0, edges_changed)

    # -- churn internals ---------------------------------------------------

    @staticmethod
    def _sig2d(arr: torch.Tensor) -> torch.Tensor:
        """(N,) or (N, F) -> (N, F) float32 for the churn kernels."""
        a = arr.to(torch.float32)
        return a[:, None] if a.ndim == 1 else a

    def _restricted_krylov(self, d2d: torch.Tensor, reach: np.ndarray, b: int):
        """Run the Krylov-returning restricted apply on bucket ``b``.

        Returns ``(idx, d_out (eta, k, F), d_stack (M+1, k, F))`` with
        ``idx`` the reach's indices on the device; the caller scatters
        both into ``_out`` / ``_tk``.
        """
        idx_t, lap_sub, d_sub = gather_reach(self._lap_dev, np.nonzero(reach)[0], b, d2d)
        k = idx_t.shape[0]
        out, stack = restricted_cheb_apply_krylov(lap_sub, d_sub, self._coeffs_dev, self._lmax)
        return idx_t, out[:, :k], stack[:, :k]

    def _scatter_out(self, idx_t: torch.Tensor, d_out: torch.Tensor) -> None:
        if self._out.ndim == 2:  # 1-D frames: _out is (eta, N)
            self._out[:, idx_t] += d_out[:, :, 0]
        else:
            self._out[:, idx_t] += d_out

    def _churn_frame(self, y, idx, touched, changed_edges, t0) -> FrameResult | None:
        """Incremental churn frame: Stage A corrects the cached output for
        the Laplacian delta (Krylov-difference recurrence on ``N_M(T)``),
        Stage B filters the signal delta on the NEW Laplacian. Returns
        None when the combined change set is too large (caller goes full).
        """
        n = y.shape[0]
        sig_delta = y - self._y
        changed = self._changed(sig_delta)
        n_sig = int(changed.sum())
        t_mask = np.zeros(n, dtype=bool)
        t_mask[touched] = True
        if int((changed | t_mask).sum()) > self.max_delta_frac * n:
            return None
        words_a, reach_a = self._walk_delta(t_mask)
        b_a = bucket_size(int(reach_a.sum()), n)
        if b_a >= n:
            return None
        if n_sig:
            words_b, reach_b = self._walk_delta(changed)
            b_b = bucket_size(int(reach_b.sum()), n)
            if b_b >= n:
                return None
        else:
            words_b, reach_b = 0, None

        # Stage A — topology correction on the previous input, on the
        # induced submatrix over N_M(T) (zero padding is a fixed point).
        idx_a = np.nonzero(reach_a)[0]
        k = len(idx_a)
        idx_t, lap_sub = gather_reach(self._lap_dev, idx_a, b_a)
        pos = np.full(n, -1, dtype=np.int64)
        pos[idx_a] = np.arange(k)
        # dL[R, R] entries, summed on the host in float32 in the
        # reference's order, then written to the device once.
        entries: dict[tuple[int, int], np.float32] = {}
        for u, v, dw in changed_edges:
            pu, pv = int(pos[u]), int(pos[v])
            for key, sign in (((pu, pv), -1.0), ((pv, pu), -1.0), ((pu, pu), 1.0), ((pv, pv), 1.0)):
                entries[key] = entries.get(key, np.float32(0.0)) + np.float32(sign * dw)
        rc = np.asarray(list(entries), dtype=np.int64)
        dlap = self._lap_dev.new_zeros((b_a, b_a))
        dlap[upload(rc[:, 0], self.device), upload(rc[:, 1], self.device)] = upload(
            np.asarray(list(entries.values()), dtype=np.float32), self.device
        )
        tk_sub = self._tk.new_zeros((self._tk.shape[0], b_a) + self._tk.shape[2:])
        tk_sub[:, :k] = self._tk[:, idx_t]
        corr, d_stack = churn_correction(lap_sub, dlap, tk_sub, self._coeffs_dev, self._lmax)
        self._scatter_out(idx_t, corr[:, :k])
        self._tk[:, idx_t] += d_stack[:, :k]

        # Stage B — the signal delta against the new Laplacian, through
        # the Krylov-returning kernel so _tk tracks the new input.
        if n_sig:
            idx_b, d_out, d_stack = self._restricted_krylov(self._sig2d(sig_delta), reach_b, b_b)
            self._scatter_out(idx_b, d_out)
            self._tk[:, idx_b] += d_stack

        self._y = y.clone()
        self.delta_frames += 1
        words = words_a + words_b
        self.words_total += words
        active = int((reach_a if reach_b is None else reach_a | reach_b).sum())
        return FrameResult(
            out=self._out.clone(),
            mode="churn",
            frame=idx,
            changed=n_sig,
            active=active,
            words=words,
            latency_s=time.perf_counter() - t0,
            host_s=self._host_s,
            edges_changed=len(changed_edges),
        )

    def _churn_signal_delta(self, y, idx, sig_delta, changed, n_changed, t0) -> FrameResult | None:
        """Signal-only delta frame on a churn-active stream."""
        if self._tk is None or not backend_supports_sparse(self.backend):
            return None
        n = y.shape[0]
        words, reach = self._walk_delta(changed)
        b = bucket_size(int(reach.sum()), n)
        if b >= n:
            return None
        idx_b, d_out, d_stack = self._restricted_krylov(self._sig2d(sig_delta), reach, b)
        self._scatter_out(idx_b, d_out)
        self._tk[:, idx_b] += d_stack
        self._y = y.clone()
        self.delta_frames += 1
        self.words_total += words
        return FrameResult(
            out=self._out.clone(),
            mode="delta",
            frame=idx,
            changed=n_changed,
            active=int(reach.sum()),
            words=words,
            latency_s=time.perf_counter() - t0,
            host_s=self._host_s,
        )

    def _full_frame(self, y, idx, n_changed, t0, edges_changed=0) -> FrameResult:
        """Full refilter. Churn-active streams answer from their own
        patched Laplacian (capturing the Krylov stack for later
        incremental frames); pristine streams use the shared filter."""
        if self._churn:
            out, self._tk = dense_cheb_apply_krylov(
                self._lap_dev, self._sig2d(y), self._coeffs_dev, self._lmax
            )
            self._out = out[:, :, 0] if y.ndim == 1 else out
        else:
            self._out = self.filt.apply(y, backend=self.backend, **self.opts)
        self._y = y.clone()
        self.full_refilters += 1
        words = self._full_words()
        self.words_total += words
        return FrameResult(
            out=self._out.clone(),
            mode="full",
            frame=idx,
            changed=n_changed,
            active=y.shape[0],
            words=words,
            latency_s=time.perf_counter() - t0,
            host_s=self._host_s,
            edges_changed=edges_changed,
        )
