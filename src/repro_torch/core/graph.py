"""Graph construction and Laplacian utilities (paper Sec. II).

Mirrors ``repro/core/graph.py``. The sensor network is an undirected
weighted graph with the thresholded-Gaussian weights of eq. (1):

    w(e_ij) = exp(-d(i,j)^2 / (2 sigma^2))  if d(i,j) <= kappa, else 0.

Dense outputs are torch tensors on the caller's device. The host-side
helpers (connectivity check, k-hop reach, spatial partition order) are
numpy copies of the reference and match it bit for bit. The random
generators draw from an explicit ``torch.Generator``; they are held to the
reference's statistics (mean degree, edge count), not to its bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "SensorGraph",
    "gaussian_kernel_weights",
    "random_sensor_graph",
    "connected_sensor_graph",
    "grid_graph",
    "ring_graph",
    "torus_graph",
    "laplacian",
    "degree_vector",
    "lmax_upper_bound",
    "lmax_power_iteration",
    "is_connected",
    "khop_neighborhood",
    "spatial_partition_order",
]


@dataclasses.dataclass(frozen=True)
class SensorGraph:
    """A weighted undirected graph plus optional vertex coordinates.

    Attributes:
      adjacency: (N, N) symmetric non-negative weight tensor, zero diagonal.
      coords:    (N, d) vertex coordinates, or None for abstract graphs.
    """

    adjacency: torch.Tensor
    coords: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.adjacency.device

    @property
    def n_vertices(self) -> int:
        return self.adjacency.shape[0]

    @property
    def n_edges(self) -> int:
        """|E| — number of undirected edges with non-zero weight."""
        return int(torch.count_nonzero(self.adjacency)) // 2

    def laplacian(self) -> torch.Tensor:
        return laplacian(self.adjacency)

    def lmax_bound(self) -> torch.Tensor:
        return lmax_upper_bound(self.adjacency)


def gaussian_kernel_weights(
    coords: torch.Tensor, sigma: float, kappa: float
) -> torch.Tensor:
    """Thresholded Gaussian kernel weights, paper eq. (1).

    Args:
      coords: (N, d) sensor positions.
      sigma: kernel width.
      kappa: connectivity radius; pairs farther than ``kappa`` get weight 0.

    Returns:
      (N, N) symmetric adjacency with zero diagonal, on ``coords.device``.
    """
    d2 = torch.sum((coords[:, None, :] - coords[None, :, :]) ** 2, dim=-1)
    w = torch.exp(-d2 / (2.0 * sigma**2))
    w = torch.where(d2 <= kappa**2, w, torch.zeros_like(w))
    w.fill_diagonal_(0.0)
    return w


def random_sensor_graph(
    generator: torch.Generator,
    n: int = 500,
    sigma: float = 0.074,
    kappa: float = 0.075,
    *,
    device: str | torch.device | None = None,
) -> SensorGraph:
    """The paper's experimental network (Sec. V-B).

    ``n`` sensors placed uniformly at random in the unit square (drawn from
    ``generator`` on its own device), weighted by the thresholded Gaussian
    kernel, built on ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    coords = torch.rand((n, 2), generator=generator, device=generator.device)
    coords = coords.to(dev)
    return SensorGraph(gaussian_kernel_weights(coords, sigma, kappa), coords)


def connected_sensor_graph(
    generator: torch.Generator,
    n: int = 500,
    sigma: float = 0.074,
    kappa: float = 0.075,
    max_tries: int = 50,
    *,
    device: str | torch.device | None = None,
) -> SensorGraph:
    """Rejection-sample ``random_sensor_graph`` until connected."""
    dev = resolve_device(device)
    for _ in range(max_tries):
        g = random_sensor_graph(generator, n, sigma, kappa, device=dev)
        if is_connected(g.adjacency.cpu().numpy()):
            return g
    raise RuntimeError(
        f"no connected graph in {max_tries} draws (n={n}, kappa={kappa})"
    )


def grid_graph(
    side: int,
    dtype: torch.dtype = torch.float32,
    *,
    device: str | torch.device | None = None,
) -> SensorGraph:
    """4-neighbour unit-weight grid on ``side x side`` vertices."""
    dev = resolve_device(device)
    n = side * side
    a = np.zeros((n, n), dtype=np.float64)
    for r in range(side):
        for c in range(side):
            i = r * side + c
            if c + 1 < side:
                a[i, i + 1] = a[i + 1, i] = 1.0
            if r + 1 < side:
                a[i, i + side] = a[i + side, i] = 1.0
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float64)
    coords /= max(side - 1, 1)
    return SensorGraph(
        torch.as_tensor(a, dtype=dtype, device=dev),
        torch.as_tensor(coords, dtype=dtype, device=dev),
    )


def ring_graph(
    n: int,
    dtype: torch.dtype = torch.float32,
    *,
    device: str | torch.device | None = None,
) -> SensorGraph:
    """Unit-weight ring C_n — the device-topology graph for gossip on a
    1-D mesh axis."""
    dev = resolve_device(device)
    a = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n)
    a[idx, (idx + 1) % n] = 1.0
    a[(idx + 1) % n, idx] = 1.0
    return SensorGraph(torch.as_tensor(a, dtype=dtype, device=dev))


def torus_graph(
    rows: int,
    cols: int,
    dtype: torch.dtype = torch.float32,
    *,
    device: str | torch.device | None = None,
) -> SensorGraph:
    """2-D torus — device-topology graph of a 2-axis mesh."""
    dev = resolve_device(device)
    n = rows * cols
    a = np.zeros((n, n), dtype=np.float64)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for rr, cc in (((r + 1) % rows, c), (r, (c + 1) % cols)):
                j = rr * cols + cc
                if i != j:
                    a[i, j] = a[j, i] = 1.0
    return SensorGraph(torch.as_tensor(a, dtype=dtype, device=dev))


def degree_vector(adjacency: torch.Tensor) -> torch.Tensor:
    return torch.sum(adjacency, dim=1)


def laplacian(adjacency: torch.Tensor) -> torch.Tensor:
    """Non-normalized graph Laplacian L = D - A (paper Sec. II)."""
    return torch.diag(degree_vector(adjacency)) - adjacency


def lmax_upper_bound(adjacency: torch.Tensor) -> torch.Tensor:
    """Anderson--Morley bound: lambda_max <= max_{m~n} (d(m) + d(n)).

    Returns a 0-dim tensor on ``adjacency.device``.
    """
    d = degree_vector(adjacency)
    pair = d[:, None] + d[None, :]
    return torch.max(torch.where(adjacency > 0, pair, torch.zeros_like(pair)))


def lmax_power_iteration(
    laplacian_matrix,
    iters: int = 100,
    *,
    v0=None,
    seed: int = 0,
    return_vector: bool = False,
):
    """Tighter lambda_max estimate via power iteration (beyond-paper knob).

    A slightly inflated Rayleigh quotient (x1.01) keeps the Chebyshev domain
    valid even if the iteration has not fully converged. Runs on the
    matrix's device (a numpy matrix is read as a CPU tensor).

    Args:
      v0: optional warm-start vector (tensor or array), e.g. the converged
        iterate from the previous topology, which the churn
        re-certification path carries across frames. Normalized
        internally; must not be the zero vector.
      seed: seed of the default start. The reference draws it from
        ``jax.random.PRNGKey(seed)``; the port draws
        ``np.random.default_rng(seed).standard_normal(n) / sqrt(n)`` and adds
        the same alternating component (+-1/n), so the start is
        deterministic per seed and not orthogonal to the top eigenspace on
        bipartite-ish graphs, but it is not the reference's start: compare
        the two packages with an explicit ``v0`` or at convergence.
      return_vector: also return the final iterate, for reuse as the next
        call's ``v0``.

    Returns:
      The estimate as a 0-dim tensor, or ``(estimate, vector)`` with
      ``return_vector``.
    """
    lap = torch.as_tensor(laplacian_matrix)
    n = lap.shape[0]
    if v0 is None:
        v = np.random.default_rng(seed).standard_normal(n) / np.sqrt(n)
        v = v + np.where(np.arange(n) % 2 == 0, 1.0, -1.0) / n
        v = torch.as_tensor(v, device=lap.device).to(lap.dtype)
    else:
        v = torch.as_tensor(v0).to(device=lap.device, dtype=lap.dtype)
    v = v / (torch.linalg.norm(v) + 1e-30)
    for _ in range(iters):
        w = lap @ v
        v = w / (torch.linalg.norm(w) + 1e-30)
    est = 1.01 * (v @ (lap @ v) / (v @ v))
    if return_vector:
        return est, v
    return est


# ---- host-side numpy helpers: copies of the reference, bit for bit -------


def is_connected(adjacency, *, ignore_isolated: bool = False) -> bool:
    """Host-side BFS connectivity check (the paper assumes connected G).

    Args:
      ignore_isolated: check connectivity of the subgraph induced on the
        non-isolated vertices only.
    """
    a = np.asarray(adjacency) > 0
    n = a.shape[0]
    has_edge = a.any(axis=1)
    if ignore_isolated:
        if not has_edge.any():
            return True
        start = int(np.argmax(has_edge))
    else:
        start = 0
    seen = np.zeros(n, dtype=bool)
    frontier = np.zeros(n, dtype=bool)
    frontier[start] = seen[start] = True
    while frontier.any():
        nxt = (a[frontier].any(axis=0)) & ~seen
        seen |= nxt
        frontier = nxt
    if ignore_isolated:
        return bool(seen[has_edge].all())
    return bool(seen.all())


def khop_neighborhood(adjacency, support, k: int) -> np.ndarray:
    """Boolean mask of vertices within ``k`` hops of ``support`` (host BFS).

    Args:
      adjacency: (N, N) weight matrix (only the zero pattern is used).
      support: (N,) boolean mask (or index array) of the seed set S.
      k: hop count >= 0.

    Returns:
      (N,) numpy boolean mask of ``N_k(S)``, including S itself.
    """
    a = np.asarray(adjacency) != 0.0
    n = a.shape[0]
    support = np.asarray(support)
    if support.dtype != np.bool_:
        mask = np.zeros(n, dtype=bool)
        mask[support] = True
    else:
        mask = support.copy()
    frontier = mask.copy()
    for _ in range(k):
        if not frontier.any():
            break
        reached = a[frontier].any(axis=0)
        frontier = reached & ~mask
        mask |= reached
    return mask


def spatial_partition_order(coords, n_parts: int) -> np.ndarray:
    """Order vertices so contiguous slabs form spatially-local partitions.

    Recursive coordinate bisection: sort by the widest axis, split in half,
    recurse. Returns a permutation of vertex ids; partition ``p`` owns
    ``order[p*N/P:(p+1)*N/P]``.
    """
    coords = np.asarray(coords)
    n = coords.shape[0]
    if n_parts <= 1:
        return np.arange(n)

    def rec(ids: np.ndarray, parts: int) -> np.ndarray:
        if parts == 1 or len(ids) <= 1:
            return ids
        c = coords[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = ids[np.argsort(c[:, axis], kind="stable")]
        left = parts // 2
        cut = len(ids) * left // parts
        return np.concatenate([rec(order[:cut], left), rec(order[cut:], parts - left)])

    return rec(np.arange(n), n_parts)
