"""Fully distributed SGWT wavelet denoising (paper Sec. V-C) over P ranks,
driven through the solver layer.

Mirrors ``examples/distributed_wavelet_ista.py``: ``repro_torch.solvers``
runs ISTA over the ``halo`` backend, so every iteration's forward W~
(Algorithm 1, Sec. IV-A) and adjoint W~* (Sec. IV-B) run through boundary
halo exchanges only. The halo backend declares ``traceable=False``, so
the solver drives it with the host loop. Checks, as the reference example
does: the distributed ISTA within 1e-3 of the centralized solver, the
denoised MSE under 0.3x the noisy one, sparsity above 0.2, words per
iteration positive and within the paper's radio bound, and FISTA at half
the iterations within 1.001x of ISTA's objective.

Run:  PYTHONPATH=src python -m repro_torch.distributed_wavelet_ista [--device cpu] [--n-parts 8]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.apps import wavelet_denoise_ista
from repro_torch.core import graph, multipliers
from repro_torch.core.collectives import StackedMesh
from repro_torch.device import resolve_device
from repro_torch.filters import GraphFilter, backend_is_traceable
from repro_torch.solvers import LassoProblem, fista, ista


def main(device: str | None = None, n_parts: int = 8, seed: int = 21) -> dict:
    dev = resolve_device(device)
    mesh = StackedMesh(n_parts, dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g = graph.connected_sensor_graph(gen, n=500, device=dev)
    f0 = g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2 - 1.0
    y = f0 + 0.5 * torch.randn(f0.shape, generator=gen).to(dev)
    lmax = float(g.lmax_bound())

    n_scales, order, n_iters, mu = 3, 20, 20, 2.0
    bank = multipliers.sgwt_filter_bank(lmax, n_scales=n_scales)
    filt = GraphFilter.from_multipliers(bank, order, graph=g, lmax=lmax)
    problem = LassoProblem(filt=filt, y=y, mu=mu)

    # ---- distributed ISTA over the halo backend (host loop, by flag) ----
    if backend_is_traceable("halo"):
        raise AssertionError("the halo backend must drive the host loop")
    res = ista(problem, n_iters=n_iters, backend="halo", mesh=mesh)

    # ---- centralized reference (same math, dense backend) ----
    fref, _ = wavelet_denoise_ista(g, y, lmax, n_scales=n_scales, order=order, mu=mu,
                                   n_iters=n_iters)

    deviation = float(torch.max(torch.abs(res.x - fref)))
    noisy = float(torch.mean((y - f0) ** 2))
    den = float(torch.mean((res.x - f0) ** 2))
    sparsity = float(torch.mean((res.aux == 0.0).to(torch.float32)))
    e, eta = g.n_edges, filt.eta
    radio_words = 2 * order * e * eta + 2 * order * e  # Sec. V-C radio model

    print(f"graph N={g.n_vertices} |E|={e}  eta={eta} M={order}  mesh P={n_parts}")
    print(f"max |distributed - centralized| = {deviation:.2e}")
    print(f"noisy MSE = {noisy:.4f}  denoised MSE = {den:.4f}  sparsity = {sparsity:.2f}")
    print(f"objective trace: {res.history[0]:.2f} -> {res.history[-1]:.2f} "
          f"in {res.iterations} iters")
    print(f"paper words/ISTA-iter (radio model) = {radio_words}")
    print(f"mesh words/iter (halo accounting)   = {res.messages_per_iteration}  "
          f"total = {res.messages_total}")
    if not deviation < 1e-3:
        raise AssertionError(f"distributed vs centralized: {deviation}")
    if not den < 0.3 * noisy:
        raise AssertionError(f"denoised {den:.4f} vs noisy {noisy:.4f}")
    if not sparsity > 0.2:
        raise AssertionError(f"sparsity {sparsity:.2f}")
    # A boundary vertex crosses each partition seam once, so the mesh can
    # never exceed the radio bound.
    if not 0 < res.messages_per_iteration <= radio_words:
        raise AssertionError(f"words/iteration {res.messages_per_iteration} vs {radio_words}")

    # ---- FISTA: same words/iter, half the iterations ----
    obj_ista = problem.objective(res.aux)
    res_f = fista(problem, n_iters=n_iters // 2, backend="halo", mesh=mesh)
    obj_fista = problem.objective(res_f.aux)
    print(f"objective after {n_iters} ISTA iters  = {obj_ista:.4f}")
    print(f"objective after {n_iters // 2} FISTA iters = {obj_fista:.4f}")
    if not obj_fista <= obj_ista * 1.001:
        raise AssertionError(f"FISTA-{n_iters // 2} {obj_fista} > ISTA-{n_iters} {obj_ista}")
    print("OK")
    return {
        "deviation": deviation,
        "noisy_mse": noisy,
        "denoised_mse": den,
        "sparsity": sparsity,
        "words_per_iteration": res.messages_per_iteration,
        "radio_words": radio_words,
        "objective_ista": obj_ista,
        "objective_fista_half": obj_fista,
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--n-parts", type=int, default=8)
    parser.add_argument("--seed", type=int, default=21)
    args = parser.parse_args()
    main(args.device, args.n_parts, args.seed)
