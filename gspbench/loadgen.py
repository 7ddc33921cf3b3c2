"""Traffic generation: sensor positions, signal panels and request traces.

Everything is drawn from the run's seed. Positions and panels are made on
the run's device from a ``torch.Generator`` there; request traces and the
serving lane's signal pool are numpy, as the program's clients send them.

* ``sensor_positions``: N sensors uniform in the unit square (paper
  Sec. V-B).
* ``field_panel``: F smooth fields ``f0(x, y) = (x - u)^2 + (y - v)^2 - 1``
  (the paper's ``x^2 + y^2 - 1``, centred at a random (u, v) per column)
  plus Gaussian noise.
* ``make_trace``: Poisson arrivals, a hot share of the streams carrying a
  share of the requests, lanes from a mix, tenants by stream: the mix of
  ``benchmarks/loadgen.py::make_trace``, with its composition fixed. Every
  seed gets the same inter-arrival gaps (the exponential distribution's
  quantiles), the same count of requests per lane and the same count of
  hot requests, in an order drawn from the seed; the seed also draws the
  stream ids and the pooled signals. Seeds differ in order, not in work.
* ``signal_pool``: the (n_signals, N) float32 payloads requests index,
  a copy of ``benchmarks/loadgen.py::make_signal_pool``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sensor_positions", "field_panel", "make_trace", "signal_pool"]


def sensor_positions(gen: torch.Generator, n: int, device: torch.device) -> torch.Tensor:
    """(n, 2) float32 positions uniform in the unit square."""
    return torch.rand((n, 2), generator=gen, device=device)


def field_panel(coords: torch.Tensor, gen: torch.Generator, f: int, noise: float) -> torch.Tensor:
    """(N, f) float32 panel of noisy smooth fields on the sensors."""
    centres = torch.rand((2, f), generator=gen, device=coords.device)
    x, y = coords[:, 0:1], coords[:, 1:2]
    f0 = (x - centres[0]) ** 2 + (y - centres[1]) ** 2 - 1.0
    eps = torch.randn(f0.shape, generator=gen, device=coords.device)
    return (f0 + noise * eps).contiguous()


def make_trace(n_streams: int, seconds: float, rate: float, *, seed: int,
               hot_frac: float = 0.01, hot_mass: float = 0.5,
               lane_mix=(0.90, 0.08, 0.02), n_tenants: int = 8,
               n_signals: int = 64) -> dict:
    """Poisson arrivals at ``rate`` per second over ``seconds``:
    ``t_arrive`` (seconds from the start), ``stream``, ``lane`` (0 apply,
    1 solve, 2 frame), ``tenant`` and ``signal`` (a pool index) per
    request. The gaps, the count per lane and the count of hot requests
    are the same for every seed; the seed orders them."""
    rng = np.random.default_rng(seed)
    n_requests = max(1, int(round(rate * seconds)))
    quantiles = (np.arange(n_requests) + 0.5) / n_requests
    t_arrive = np.cumsum(rng.permutation(-np.log1p(-quantiles) / rate))
    n_hot = max(1, int(round(hot_frac * n_streams)))
    is_hot = rng.permutation(np.arange(n_requests) < int(round(hot_mass * n_requests)))
    hot_ids = rng.integers(0, n_hot, n_requests)
    cold_ids = (rng.integers(0, max(n_streams - n_hot, 1), n_requests) + n_hot).clip(
        max=n_streams - 1)
    stream = np.where(is_hot, hot_ids, cold_ids)
    lane = rng.permutation(np.repeat(np.arange(3), _counts(lane_mix, n_requests)))
    return {"t_arrive": t_arrive, "stream": stream.astype(np.int64), "lane": lane.astype(np.int8),
            "tenant": (stream % n_tenants).astype(np.int64),
            "signal": rng.integers(0, n_signals, n_requests)}


def _counts(shares, n: int) -> np.ndarray:
    """``n`` split in proportion to ``shares`` by largest remainders."""
    want = np.asarray(shares, np.float64) / float(np.sum(shares)) * n
    counts = np.floor(want).astype(np.int64)
    counts[np.argsort(counts - want)[: n - int(counts.sum())]] += 1
    return counts


def signal_pool(n_vertices: int, n_signals: int, seed: int) -> np.ndarray:
    """(n_signals, N) float32 standard normal payloads."""
    return np.random.default_rng(seed + 1).normal(size=(n_signals, n_vertices)).astype(np.float32)
