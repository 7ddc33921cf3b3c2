"""Incremental Laplacian updates and churn-time filter corrections.

Mirrors ``repro/dynamic/delta.py``. Topology churn is first-class:

* ``GraphDelta`` — a canonical batch of edge reweights (add = from 0,
  remove = to 0) plus vertex join/leave constructors under the slot-pool
  model: a vertex never disappears from the matrix, it becomes an isolated
  slot, so every array shape is preserved across arbitrary churn.
* ``apply_graph_delta`` / ``apply_delta_inplace`` — functional (on the
  graph's device) and in-place host (O(|delta|) for the Laplacian)
  applications of a delta.
* ``LmaxTracker`` — a cheaply re-certified upper bound on ``lambda_max``
  (host numpy bookkeeping): rank-one degree bookkeeping keeps an
  Anderson--Morley bound valid in O(deg) per changed edge; only when the
  running bound degrades past the filter's domain does it fall back to an
  exact AM recompute and then a warm-started power iteration, which runs
  on the Laplacian's device.
* The churn-correction kernels, on the device of their operands. With the
  Krylov stack ``t_k = Tbar_k(L) f`` retained from the previous frame
  (``cheb_apply_krylov``), the difference stack
  ``D_k := Tbar_k(L') f - Tbar_k(L) f`` for ``L' = L + dL`` obeys

      D_0 = 0,   D_1 = dL f / alpha,
      D_k = (2/alpha) (L' - alpha I) D_{k-1} - D_{k-2}
            + (2/alpha) dL t_{k-1},            k >= 2,

  and ``supp(D_k) ⊆ N_{k-1}(T)`` for the changed-edge endpoints T, so
  the degree-M correction is exact on the induced submatrix over
  ``N_M(T)``; zero-padding to a power-of-two bucket is a fixed point of
  the recurrence. The reference leaves these dense matmuls to XLA, and
  the port to ``torch.matmul``; they keep the reference's recurrence
  formula, ``(2/alpha)(L t - alpha t) - t_{k-2}``.

The host half (``GraphDelta``, ``apply_delta_inplace``, the
``LmaxTracker`` bookkeeping) is the reference's numpy, copied.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import chebyshev
from repro_torch.core.graph import SensorGraph, lmax_power_iteration

__all__ = [
    "GraphDelta",
    "apply_graph_delta",
    "apply_delta_inplace",
    "LmaxTracker",
    "churn_correction",
    "restricted_cheb_apply_krylov",
    "dense_cheb_apply_krylov",
    "kernel_trace_counts",
]


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A batch of topology changes between two consecutive frames.

    Attributes:
      edges: ``(u, v, new_weight)`` triples. ``new_weight`` is the
        *target* weight (not an increment): 0 removes the edge, a fresh
        pair adds one. Canonicalized on construction — ``u < v``,
        self-loops dropped, duplicate pairs last-wins.
      coords: optional (N, d) updated vertex coordinates (mobile fleets);
        carried through for plan-repair consumers that track geometry.
    """

    edges: tuple[tuple[int, int, float], ...]
    coords: np.ndarray | None = None

    def __post_init__(self):
        canon: dict[tuple[int, int], float] = {}
        for u, v, w in self.edges:
            u, v = int(u), int(v)
            if u == v:
                continue
            if u > v:
                u, v = v, u
            canon[(u, v)] = float(w)
        object.__setattr__(
            self, "edges", tuple((u, v, w) for (u, v), w in sorted(canon.items()))
        )

    def __len__(self) -> int:
        return len(self.edges)

    @property
    def touched(self) -> np.ndarray:
        """Sorted unique endpoints of every delta edge (the set T)."""
        if not self.edges:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.asarray([(u, v) for u, v, _ in self.edges], dtype=np.int64))

    @classmethod
    def vertex_leave(cls, adjacency, vertex: int) -> "GraphDelta":
        """Vertex departure under the slot-pool model: zero every incident
        edge, leaving an isolated slot (shapes unchanged). ``adjacency`` is
        host array-like (a tensor is read on the host)."""
        a = adjacency.cpu().numpy() if isinstance(adjacency, torch.Tensor) else adjacency
        nbrs = np.nonzero(a[vertex])[0]
        return cls(tuple((int(vertex), int(n), 0.0) for n in nbrs))

    @classmethod
    def vertex_join(
        cls,
        vertex: int,
        neighbors: Sequence[int],
        weights: Sequence[float] | float = 1.0,
    ) -> "GraphDelta":
        """Vertex arrival: an isolated slot gains edges to ``neighbors``."""
        neighbors = [int(n) for n in neighbors]
        if np.ndim(weights) == 0:
            weights = [float(weights)] * len(neighbors)
        return cls(tuple((int(vertex), n, float(w)) for n, w in zip(neighbors, weights)))


def apply_graph_delta(graph: SensorGraph, delta: GraphDelta) -> SensorGraph:
    """Functionally apply a delta, returning a new ``SensorGraph`` on the
    input graph's device (the edge writes are device ops; new coordinates,
    when the delta carries them, are uploaded in the adjacency's dtype).

    The from-scratch reference for the incremental paths.
    """
    a = graph.adjacency.clone()
    if delta.edges:
        e = np.asarray(delta.edges, dtype=np.float64)
        u = torch.as_tensor(e[:, 0].astype(np.int64), device=a.device)
        v = torch.as_tensor(e[:, 1].astype(np.int64), device=a.device)
        w = torch.as_tensor(e[:, 2], device=a.device).to(a.dtype)
        a[u, v] = w
        a[v, u] = w
    coords = graph.coords
    if delta.coords is not None:
        coords = torch.as_tensor(np.asarray(delta.coords), device=a.device).to(a.dtype)
    return SensorGraph(a, coords)


def apply_delta_inplace(
    adj: np.ndarray,
    lap: np.ndarray | None,
    delta: GraphDelta,
) -> tuple[np.ndarray, list[tuple[int, int, float]]]:
    """Mutate host adjacency (and Laplacian) in place; O(|delta|) work.

    Returns ``(touched, changed)`` where ``changed`` is the list of
    ``(u, v, dw)`` with ``dw = new - old`` for edges whose weight actually
    moved (no-op entries are dropped — their endpoints do not enter T),
    and ``touched`` are the sorted unique endpoints of ``changed``.
    """
    changed: list[tuple[int, int, float]] = []
    for u, v, w in delta.edges:
        dw = float(w) - float(adj[u, v])
        if dw == 0.0:
            continue
        adj[u, v] = adj[v, u] = w
        if lap is not None:
            lap[u, v] -= dw
            lap[v, u] -= dw
            lap[u, u] += dw
            lap[v, v] += dw
        changed.append((u, v, dw))
    if not changed:
        return np.zeros(0, dtype=np.int64), changed
    touched = np.unique(np.asarray([(u, v) for u, v, _ in changed], dtype=np.int64))
    return touched, changed


def _exact_am_bound(adj: np.ndarray, deg: np.ndarray) -> float:
    """Anderson--Morley: lambda_max <= max over edges of deg(u) + deg(v)."""
    pair = deg[:, None] + deg[None, :]
    masked = np.where(np.asarray(adj) > 0, pair, 0.0)
    return float(masked.max()) if masked.size else 0.0


class LmaxTracker:
    """Incrementally certified upper bound on ``lambda_max(L)`` (host).

    Invariant: ``self.bound >= lambda_max`` of the current adjacency at
    all times (while ``method != "power"``, it even dominates the exact
    AM bound). Degrees change only at the endpoints of changed edges, so
    the max of the previous bound and the fresh pair-sums of every edge
    incident to them dominates the new AM bound. The running bound never
    decreases (edge removals loosen it), which is why ``recertify``
    exists.
    """

    def __init__(self, adjacency: np.ndarray):
        a = np.asarray(adjacency)
        self.deg = a.sum(axis=1, dtype=np.float64)
        self.bound = _exact_am_bound(a, self.deg)
        self.method = "exact-am"
        self.recertifications = 0
        self._v: torch.Tensor | None = None  # warm-start iterate across calls

    def update(self, adj: np.ndarray, changed: Iterable[tuple[int, int, float]]) -> float:
        """Fold a batch of edge changes into the certificate (cheap path)."""
        changed = list(changed)
        touched = set()
        for u, v, dw in changed:
            self.deg[u] += dw
            self.deg[v] += dw
            touched.add(u)
            touched.add(v)
        cand = 0.0
        for u in touched:
            nbrs = np.nonzero(np.asarray(adj[u]) > 0)[0]
            if nbrs.size:
                cand = max(cand, float((self.deg[u] + self.deg[nbrs]).max()))
        self.bound = max(self.bound, cand)
        self.method = "incremental-am"
        return self.bound

    def recertify(self, adj: np.ndarray) -> float:
        """Exact Anderson--Morley recompute — drops accumulated slack."""
        a = np.asarray(adj)
        self.deg = a.sum(axis=1, dtype=np.float64)
        self.bound = _exact_am_bound(a, self.deg)
        self.method = "exact-am"
        self.recertifications += 1
        return self.bound

    def power_estimate(self, lap, *, iters: int = 50) -> float:
        """Tighten past AM with power iteration in float32 (as the
        reference's ``jnp.asarray`` reads the matrix), warm-started from
        the previous topology's iterate. Runs on ``lap``'s device: a
        churn-active stream passes its device Laplacian, a host array runs
        on the CPU. The first call starts from ``lmax_power_iteration``'s
        seeded default, which is not the reference's (see its docstring)."""
        est, v = lmax_power_iteration(
            torch.as_tensor(lap).to(torch.float32), iters, v0=self._v, return_vector=True
        )
        self._v = v
        est = float(est)
        if est < self.bound:
            self.bound = est
            self.method = "power"
        return self.bound


# ---------------------------------------------------------------------------
# Churn kernels. ``jax.jit`` keys its compile cache on the shapes and dtypes
# of the array arguments, and the reference counts the traces it makes. Eager
# torch compiles nothing, so the port counts the same keys: per function, the
# distinct (shape, dtype) signatures of its array arguments. A frame whose
# reach pads to an already-seen power-of-two bucket adds none.
# ---------------------------------------------------------------------------

_KERNEL_KEYS: defaultdict[str, set] = defaultdict(set)


def _note(name: str, *arrays) -> None:
    _KERNEL_KEYS[name].add(tuple((tuple(np.shape(a)), str(a.dtype)) for a in arrays))


def kernel_trace_counts() -> dict[str, int]:
    """Per churn kernel, the number of distinct ``(bucket shape, dtype)``
    keys it has been called with so far: the keys ``jax.jit`` would have
    compiled a program for, so the reference's "zero steady-state
    retraces" pin reads as "no new key" here."""
    return {name: len(keys) for name, keys in _KERNEL_KEYS.items()}


def churn_correction(lap_new_sub, dlap_sub, tk_sub, coeffs, lmax):
    """Exact filter-output correction after a Laplacian delta.

    Evaluates the difference recurrence (module docstring) on the induced
    submatrix over ``N_M(T)``, zero-padded to a bucket of size b.

    Args:
      lap_new_sub: (b, b) induced NEW Laplacian ``L'[R, R]``.
      dlap_sub: (b, b) induced delta ``dL[R, R]``.
      tk_sub: (M+1, b, F) previous Krylov stack restricted to R.
      coeffs: (eta, M+1) Chebyshev coefficients (a tensor on ``tk_sub``'s
        device, or a host array uploaded per call).
      lmax: spectrum bound the coefficients were expanded on.

    Returns:
      ``(corr, d_stack)``: (eta, b, F) output correction and the
      (M+1, b, F) difference stack.
    """
    _note("churn_correction", lap_new_sub, dlap_sub, tk_sub, coeffs)
    coeffs = chebyshev._cast_coeffs(coeffs, tk_sub)
    alpha = chebyshev._alpha(lmax, tk_sub)
    d0 = torch.zeros_like(tk_sub[0])
    d1 = (dlap_sub @ tk_sub[0]) / alpha
    # D_0 = 0, so the c_0/2 reconstruction term never contributes.
    acc = chebyshev._outer(coeffs[:, 1], d1)
    ds = [d0, d1]
    d_prev1, d_prev2 = d1, d0
    for k in range(2, coeffs.shape[1]):
        d_k = (
            (2.0 / alpha) * (lap_new_sub @ d_prev1 - alpha * d_prev1)
            - d_prev2
            + (2.0 / alpha) * (dlap_sub @ tk_sub[k - 1])
        )
        acc = acc + chebyshev._outer(coeffs[:, k], d_k)
        ds.append(d_k)
        d_prev1, d_prev2 = d_k, d_prev1
    return acc, torch.stack(ds)


def restricted_cheb_apply_krylov(lap_sub, d_sub, coeffs, lmax):
    """Signal-delta filtering on an induced submatrix, keeping the Krylov
    difference stack so the stored ``t_k`` can be updated too."""
    _note("restricted_cheb_apply_krylov", lap_sub, d_sub, coeffs)
    return chebyshev.cheb_apply_krylov(lambda v: lap_sub @ v, d_sub, coeffs, lmax)


def dense_cheb_apply_krylov(lap, f, coeffs, lmax):
    """Full dense refilter that captures the Krylov stack — the churn
    path's activation / fallback frame."""
    _note("dense_cheb_apply_krylov", lap, f, coeffs)
    return chebyshev.cheb_apply_krylov(lambda v: lap @ v, f, coeffs, lmax)
