"""Streaming denoising over a frame sequence.

Mirrors ``examples/streaming_denoising.py``. A hot spot walks across a
64 x 64 grid scene: each frame differs from the previous one on a small
square patch. The streaming lane filters only the delta (the Chebyshev
recurrence of a sparsely supported change touches just its order-hop
neighbourhood), so halo words per frame track the boundary of change, not
N. A warm-started Wiener lane then reconstructs a slowly varying sensor
stream in no more CG iterations per frame than a cold solve. Checks, as
the reference example does:

  * every frame's output equals the full refilter within 1e-5;
  * the delta path engaged on every frame after the first;
  * the engine's streaming lane answers frames in order;
  * warm Wiener iterations on the last frame <= the cold solve's.

Run:  PYTHONPATH=src python -m repro_torch.streaming_denoising [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import graph, multipliers
from repro_torch.device import resolve_device
from repro_torch.filters import GraphFilter
from repro_torch.serve import GraphFilterEngine
from repro_torch.stream import StreamingFilter, StreamingWiener


def main(device: str | None = None, seed: int = 5) -> dict:
    dev = resolve_device(device)
    side, order, n_parts, patch = 64, 20, 8, 9
    g = graph.grid_graph(side, device=dev)
    n = side * side
    rng = np.random.default_rng(3)
    coords = g.coords.cpu().numpy()
    base = np.asarray(coords[:, 0] ** 2 + coords[:, 1] ** 2, np.float32) \
        + 0.3 * rng.normal(size=n).astype(np.float32)

    filt = GraphFilter.from_multipliers([multipliers.tikhonov(1.0, 1)], order, graph=g, lmax=8.0)

    # -- delta filtering: a hot spot moving one patch-width per frame ----
    lane = StreamingFilter(filt, backend="dense", n_parts=n_parts, device=dev)
    frames = []
    y = base.copy()
    for t in range(6):
        r0, c0 = 8 + 6 * t, 12 + 5 * t
        rr, cc = np.meshgrid(np.arange(r0, r0 + patch), np.arange(c0, c0 + patch), indexing="ij")
        y = y.copy()
        y[(rr * side + cc).ravel()] += 0.8
        frames.append(y)

    print(f"{'frame':>5s} {'mode':>6s} {'changed':>8s} {'active':>7s} "
          f"{'words':>7s} {'words/full':>10s}")
    full_words = order * lane._plan.halo_words
    worst, records = 0.0, []
    for y_t in frames:
        res = lane.push(y_t)
        print(f"{res.frame:5d} {res.mode:>6s} {res.changed:8d} {res.active:7d} "
              f"{res.words:7d} {res.words / full_words:10.3f}")
        # every frame's output equals the full refilter, to float tolerance
        ref = filt.apply(torch.from_numpy(y_t).to(dev), backend="dense")
        err = float((res.out - ref).abs().max())
        if err >= 1e-5:
            raise AssertionError(f"delta output deviates from full refilter: {err}")
        worst = max(worst, err)
        records.append((res.mode, res.changed, res.active, res.words))
    if lane.delta_frames < len(frames) - 1:
        raise AssertionError("delta path did not engage")

    # -- the engine's streaming lane: same thing, served ------------------
    eng = GraphFilterEngine(filt, backend="dense", panel_width=4,
                            stream_opts={"n_parts": n_parts}, device=dev)
    served = []
    for y_t in frames:
        served.extend(eng.submit_frame("scene-0", y_t) or [])
    served.extend(eng.flush_frames() or [])
    if [r.frame for r in served] != list(range(len(frames))):
        raise AssertionError(f"engine frame order {[r.frame for r in served]}")
    print(f"engine: {eng.frames_served} frames, {eng.stream_words} total halo words, "
          f"{1e3 * eng.stream_latency_s / eng.frames_served:.1f} ms/frame")

    # -- warm-started Wiener reconstruction on a sensor stream -----------
    gen = torch.Generator().manual_seed(seed)
    gs = graph.connected_sensor_graph(gen, n=400, sigma=0.085, kappa=0.086, device=dev)
    ns = gs.n_vertices
    wfilt = GraphFilter.from_multipliers([multipliers.heat(0.5)], order, graph=gs)
    sc = gs.coords.cpu().numpy()
    scene = np.asarray(sc[:, 0] ** 2 + sc[:, 1] ** 2 - 1.0, np.float32)
    ys = [scene + 0.5 * torch.randn(ns, generator=gen).numpy()]
    for _ in range(3):
        nxt = ys[-1].copy()
        ch = rng.choice(ns, size=ns // 50, replace=False)
        nxt[ch] += 0.2 * rng.normal(size=len(ch)).astype(np.float32)
        ys.append(nxt)

    wlane = StreamingWiener(wfilt, noise_power=0.25, tol=1e-6, n_iters=200, device=dev)
    warm_iters = [wlane.push(y_t).iterations for y_t in ys]
    wlane.reset()
    cold_last = wlane.push(ys[-1]).iterations
    print(f"wiener CG iterations/frame warm-started: {warm_iters} "
          f"(cold solve of the last frame: {cold_last})")
    if warm_iters[-1] > cold_last:
        raise AssertionError(f"warm {warm_iters[-1]} > cold {cold_last} iterations")
    print("OK")
    return {
        "records": records,
        "max_err": worst,
        "delta_frames": lane.delta_frames,
        "engine_frames": [r.frame for r in served],
        "engine_words": eng.stream_words,
        "warm_iters": warm_iters,
        "cold_iters": cold_last,
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=5)
    args = parser.parse_args()
    main(args.device, args.seed)
