"""Quickstart: the paper's Sec. V-B denoising experiment on the port.

Mirrors ``examples/quickstart.py``. Builds the 500-sensor random geometric
network, corrupts the smooth field ``f0(n) = nx^2 + ny^2 - 1`` with
N(0, 0.25) noise, and denoises with the Chebyshev approximation of the
Prop. 1 multiplier ``tau / (tau + 2 lambda)`` (tau = r = 1, M = 20) on the
``dense`` backend, then through the ``bsr`` backend (the CUDA kernels on a
card, their plain versions on the CPU), then heat smoothing and
semi-supervised classification. Expected: noisy MSE ~ 0.25, denoised
MSE ~ 0.013.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.apps import smooth_heat, ssl_classify
from repro_torch.core import graph, multipliers
from repro_torch.device import resolve_device
from repro_torch.filters import GraphFilter, available_backends


def main(device: str | None = None, seed: int = 0) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g = graph.connected_sensor_graph(gen, n=500, device=dev)  # sigma=0.074, r=0.075
    print(f"graph: N={g.n_vertices} |E|={g.n_edges} device={dev}")
    print(f"filter backends: {available_backends()}")

    f0 = g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2 - 1.0
    noise = torch.randn(f0.shape, generator=gen).to(dev)
    y = f0 + 0.5 * noise

    filt = GraphFilter.from_multipliers([multipliers.tikhonov(1.0, 1)], order=20, graph=g)
    fhat = filt.apply(y, backend="dense")[0]
    noisy = float(torch.mean((y - f0) ** 2))
    denoised = float(torch.mean((fhat - f0) ** 2))
    print(f"noisy    MSE = {noisy:.4f}   (paper: ~0.250)")
    print(f"denoised MSE = {denoised:.4f}   (paper: ~0.013)")

    errs = {}
    for fuse in (True, False):
        fhat_bsr = filt.apply(y, backend="bsr", fuse=fuse)[0]
        errs[fuse] = float(torch.max(torch.abs(fhat_bsr - fhat)))
        print(f"bsr backend (fuse={fuse}) max |delta| vs dense = {errs[fuse]:.2e}")
        if errs[fuse] >= 1e-4:
            raise AssertionError(f"bsr (fuse={fuse}) differs from dense by {errs[fuse]:.2e}")

    smoothed = smooth_heat(g, y, filt.lmax, t=2.0, order=20, backend="bsr")
    heat = float(torch.mean((smoothed - f0) ** 2))
    print(f"heat-smoothed MSE = {heat:.4f}")

    true_label = torch.where(f0 >= torch.median(f0), 1.0, -1.0)
    mask = (torch.rand(f0.shape, generator=gen) < 0.1).to(dev)
    pred = ssl_classify(g, torch.where(mask, true_label, 0.0), filt.lmax, backend="bsr")
    acc = float(torch.mean((pred == true_label)[~mask].to(torch.float32)))
    print(f"SSL accuracy on unlabelled nodes = {acc:.3f} ({int(mask.sum())} labels revealed)")
    return {
        "noisy_mse": noisy,
        "denoised_mse": denoised,
        "bsr_fused_err": errs[True],
        "bsr_stepwise_err": errs[False],
        "heat_mse": heat,
        "ssl_accuracy": acc,
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(args.device, args.seed)
