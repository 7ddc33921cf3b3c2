"""Mobile-sensor churn scenarios: waypoint motion, birth/death, k-NN edges.

Mirrors ``repro/dynamic/scenarios.py``: the generator is the reference's
numpy, copied, so the same seed gives the same frames bit for bit; only
``graph0`` differs in kind (a port ``SensorGraph`` on ``device=``).

Generates the workload the churn subsystem is benchmarked and tested on:
a fleet of sensors in the unit square whose *topology* changes every frame.

Slot-pool model: the adjacency is always (n_slots, n_slots). A sensor that
dies (Poisson death process) keeps its slot but loses every incident edge —
an isolated slot; a birth re-activates an idle slot at a fresh position.
Array shapes therefore never change under churn, so every bucketed kernel
shape survives arbitrary join/leave sequences.

Two mobility models:

* ``"waypoint"`` — classic random waypoint: each mobile sensor walks toward
  a private uniform target, pauses, then redraws. Mobile set fixed at t=0.
* ``"convoy"`` — the mobile set is whichever sensors currently sit inside a
  disk around a drifting center (itself a random-waypoint walker); they are
  advected with the center plus jitter. Churn is spatially *clustered*,
  which is the regime where Chebyshev locality pays: the changed-edge
  endpoints T stay compact, so ``N_M(T)`` covers a small fraction of the
  fleet and the incremental path beats the rebuild on both words and time.

Edges are re-resolved every frame as a symmetric k-NN graph over the active
sensors with Gaussian kernel weights (paper eq. 1 without the threshold —
k-NN already bounds the degree). The per-frame ``GraphDelta`` is the exact
diff of consecutive adjacencies, so "one sensor moved" naturally yields a
handful of edge removals + additions at its old/new neighborhoods.

The signal couples to the motion: a static quadratic field plus a
compactly-supported bump that rides the drifting center, so each frame has
a sparse *signal* delta (nodes near the bump + nodes that moved) alongside
the topology delta — exercising both stages of the churn filter path.

Everything is driven by one ``np.random.default_rng(seed)``: scenarios are
bit-reproducible.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import SensorGraph
from repro_torch.device import resolve_device
from repro_torch.dynamic.delta import GraphDelta

__all__ = ["ScenarioFrame", "MobileSensorScenario", "mobile_sensor_scenario"]


@dataclasses.dataclass(frozen=True)
class ScenarioFrame:
    """One frame of a churn scenario.

    Attributes:
      signal: (n_slots,) float32 frame; zero on inactive slots.
      delta: topology changes since the previous frame (None on frame 0).
      n_active: live sensors this frame.
      edges_changed: number of edge weights that differ from last frame.
      churn_fraction: ``edges_changed / max(current edge count, 1)``.
    """

    signal: np.ndarray
    delta: GraphDelta | None
    n_active: int
    edges_changed: int
    churn_fraction: float


@dataclasses.dataclass(frozen=True)
class MobileSensorScenario:
    graph0: SensorGraph
    frames: tuple[ScenarioFrame, ...]
    mean_churn: float  # mean churn_fraction over frames 1..T


def _knn_adjacency(pos: np.ndarray, active: np.ndarray, k: int, sigma: float) -> np.ndarray:
    """Symmetric k-NN adjacency over active slots, Gaussian weights."""
    n = pos.shape[0]
    a = np.zeros((n, n), dtype=np.float64)
    ids = np.nonzero(active)[0]
    if ids.size < 2:
        return a
    p = pos[ids]
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    kk = min(k, ids.size - 1)
    nn = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
    w = np.exp(-np.take_along_axis(d2, nn, axis=1) / (2.0 * sigma**2))
    rows = np.repeat(ids, kk)
    cols = ids[nn.ravel()]
    a[rows, cols] = np.maximum(a[rows, cols], w.ravel())
    # symmetrize: union of directed k-NN edges
    a = np.maximum(a, a.T)
    return a


def _bump(pos: np.ndarray, center: np.ndarray, radius: float, amp: float) -> np.ndarray:
    """Compactly supported bump — exact zeros outside ``radius`` so the
    per-frame signal delta is genuinely sparse (no Gaussian tails)."""
    d2 = ((pos - center) ** 2).sum(-1)
    x = np.maximum(0.0, 1.0 - d2 / radius**2)
    return amp * x * x


def mobile_sensor_scenario(
    n_slots: int = 192,
    n_frames: int = 12,
    *,
    k: int = 4,
    active_frac: float = 0.85,
    mobility: str = "waypoint",
    move_frac: float = 0.2,
    speed: float = 0.03,
    pause_prob: float = 0.2,
    cluster_radius: float = 0.12,
    birth_rate: float = 0.4,
    death_rate: float = 0.4,
    sigma: float | None = None,
    bump_radius: float = 0.3,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> MobileSensorScenario:
    """Generate a deterministic mobile-sensor churn scenario.

    Args:
      n_slots: size of the slot pool (matrix dimension, fixed forever).
      n_frames: number of frames, including the initial one (delta=None).
      k: k-NN degree for edge re-resolution.
      active_frac: fraction of slots initially live.
      mobility: ``"waypoint"`` or ``"convoy"`` (see module docstring).
      move_frac: (waypoint) fraction of live sensors that are mobile.
      speed: per-frame step length of mobile sensors / the convoy center.
      pause_prob: (waypoint) chance a mobile sensor pauses this frame.
      cluster_radius: (convoy) radius of the advected disk.
      birth_rate, death_rate: Poisson rates of joins/leaves per frame.
      sigma: Gaussian weight width; default ``1.5 / sqrt(n_slots)``
        (≈ the typical nearest-neighbor spacing).
      bump_radius: support radius of the moving signal bump.
      seed: master RNG seed.
      device: where ``graph0`` lives (default ``cuda``); frames and
        deltas are host numpy.
    """
    if mobility not in ("waypoint", "convoy"):
        raise ValueError(f"unknown mobility model {mobility!r}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sigma = float(sigma) if sigma is not None else 1.5 / np.sqrt(n_slots)

    pos = rng.uniform(size=(n_slots, 2))
    active = np.zeros(n_slots, dtype=bool)
    active[rng.permutation(n_slots)[: max(2, int(round(active_frac * n_slots)))]] = True

    center = rng.uniform(size=2)
    center_target = rng.uniform(size=2)
    if mobility == "waypoint":
        mobile = active & (rng.uniform(size=n_slots) < move_frac)
        targets = rng.uniform(size=(n_slots, 2))

    def step_toward(p: np.ndarray, t: np.ndarray, step: float):
        d = t - p
        dist = np.linalg.norm(d, axis=-1, keepdims=True)
        arrived = dist[..., 0] <= step
        p = np.where(arrived[..., None], t, p + step * d / np.maximum(dist, 1e-12))
        return p, arrived

    def make_signal() -> np.ndarray:
        base = pos[:, 0] ** 2 + pos[:, 1] ** 2
        sig = base + _bump(pos, center, bump_radius, amp=2.0)
        return (sig * active).astype(np.float32)

    adj = _knn_adjacency(pos, active, k, sigma)
    graph0 = SensorGraph(
        torch.as_tensor(adj, device=dev).to(torch.float32),
        torch.as_tensor(pos, device=dev).to(torch.float32),
    )
    # Diff against the float32 matrix the consumers actually hold, so the
    # delta's target weights match SensorGraph / StreamingFilter storage.
    prev = np.asarray(adj, np.float32)
    frames = [
        ScenarioFrame(
            signal=make_signal(),
            delta=None,
            n_active=int(active.sum()),
            edges_changed=0,
            churn_fraction=0.0,
        )
    ]

    for _ in range(1, n_frames):
        # --- deaths / births (slot pool: shapes never change) -------------
        live = np.nonzero(active)[0]
        for v in rng.choice(live, size=min(rng.poisson(death_rate), max(live.size - 2, 0)), replace=False):
            active[v] = False
        idle = np.nonzero(~active)[0]
        for v in rng.choice(idle, size=min(rng.poisson(birth_rate), idle.size), replace=False):
            active[v] = True
            pos[v] = rng.uniform(size=2)

        # --- motion -------------------------------------------------------
        center, arrived = step_toward(center, center_target, speed)
        if arrived:
            center_target = rng.uniform(size=2)
        if mobility == "convoy":
            in_disk = active & (((pos - center) ** 2).sum(-1) < cluster_radius**2)
            drift = (center_target - center)
            drift = speed * drift / max(np.linalg.norm(drift), 1e-12)
            pos[in_disk] += drift + 0.25 * speed * rng.standard_normal((int(in_disk.sum()), 2))
            np.clip(pos, 0.0, 1.0, out=pos)
        else:
            moving = mobile & active & (rng.uniform(size=n_slots) >= pause_prob)
            stepped, arrived = step_toward(pos[moving], targets[moving], speed)
            pos[moving] = stepped
            midx = np.nonzero(moving)[0][arrived]
            targets[midx] = rng.uniform(size=(midx.size, 2))

        # --- k-NN re-resolution + exact delta ------------------------------
        adj = np.asarray(_knn_adjacency(pos, active, k, sigma), np.float32)
        uu, vv = np.nonzero(np.triu(adj != prev, 1))
        delta = GraphDelta(
            tuple((int(u), int(v), float(adj[u, v])) for u, v in zip(uu, vv)),
            coords=pos.copy(),
        )
        n_edges = int(np.count_nonzero(adj) // 2)
        frames.append(
            ScenarioFrame(
                signal=make_signal(),
                delta=delta,
                n_active=int(active.sum()),
                edges_changed=len(delta),
                churn_fraction=len(delta) / max(n_edges, 1),
            )
        )
        prev = adj

    churn = [f.churn_fraction for f in frames[1:]]
    return MobileSensorScenario(
        graph0=graph0,
        frames=tuple(frames),
        mean_churn=float(np.mean(churn)) if churn else 0.0,
    )
