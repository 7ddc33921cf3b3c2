"""Distributed denoising over P ranks (paper Sec. IV + V-B), through the
``GraphFilter`` backend layer.

Mirrors ``examples/distributed_denoising.py``. Algorithm 1 across P ranks
(default 8) stacked on one device: the 500-vertex sensor graph is
spatially partitioned, each rank owns a vertex slab, and every Chebyshev
order exchanges only partition-boundary values (``backend="halo"``; the
``"allgather"`` backend is the naive baseline). Checks, as the reference
example does:

  * distributed result == centralized result (both backends, 1e-4),
  * halo communication <= the paper's 2M|E| radio bound,
  * denoising quality (denoised MSE < 0.05 < noisy MSE),
  * the distributed adjoint against the gram (1e-3) and the adjoint
    inner-product identity (1e-2 relative).

Run:  PYTHONPATH=src python -m repro_torch.distributed_denoising [--device cpu] [--n-parts 8]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import graph, multipliers
from repro_torch.core.collectives import StackedMesh
from repro_torch.device import resolve_device
from repro_torch.filters import GraphFilter


def main(device: str | None = None, n_parts: int = 8, seed: int = 7) -> dict:
    dev = resolve_device(device)
    mesh = StackedMesh(n_parts, dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g = graph.connected_sensor_graph(gen, n=500, device=dev)
    f0 = g.coords[:, 0] ** 2 + g.coords[:, 1] ** 2 - 1.0
    y = f0 + 0.5 * torch.randn(f0.shape, generator=gen).to(dev)
    order = 20

    filt = GraphFilter.from_multipliers([multipliers.tikhonov(1.0, 1)], order, graph=g)

    results, words = {}, {}
    for backend in ("halo", "allgather"):
        fhat = filt.apply(y, backend=backend, mesh=mesh)[0]
        results[backend] = fhat
        words[backend] = filt.messages_per_apply(backend=backend, mesh=mesh)
        print(f"[{backend:9s}] words/apply = {words[backend]:8d}   "
              f"MSE = {float(torch.mean((fhat - f0) ** 2)):.4f}")

    # Centralized reference through the same filter object.
    central = filt.apply(y, backend="dense")[0]
    errs = {}
    for backend, fhat in results.items():
        errs[backend] = float(torch.max(torch.abs(fhat - central)))
        print(f"[{backend:9s}] max |distributed - centralized| = {errs[backend]:.2e}")
        if errs[backend] >= 1e-4:
            raise AssertionError(f"{backend} deviates from centralized: {errs[backend]}")

    # Communication accounting against the paper's radio model.
    paper_words = 2 * order * g.n_edges  # 2M|E| length-1 messages
    print(f"paper radio bound 2M|E|      = {paper_words}")
    print(f"halo exchange (mesh)         = {words['halo']}  "
          f"({words['halo'] / paper_words:.2f}x of radio bound)")
    print(f"allgather baseline           = {words['allgather']}  "
          f"({words['allgather'] / words['halo']:.1f}x of halo)")
    if words["halo"] > paper_words:
        raise AssertionError("halo must not exceed the radio bound")

    noisy_mse = float(torch.mean((y - f0) ** 2))
    den_mse = float(torch.mean((results["halo"] - f0) ** 2))
    print(f"noisy MSE = {noisy_mse:.4f}, denoised MSE = {den_mse:.4f}")
    if not den_mse < 0.05 < noisy_mse:
        raise AssertionError(f"denoised {den_mse:.4f} / noisy {noisy_mse:.4f}")

    # Distributed adjoint and gram (paper Sec. IV-B/C): the identities
    # hold on the mesh as they do centralized.
    bank = multipliers.sgwt_filter_bank(filt.lmax, n_scales=3)
    wop = GraphFilter.from_multipliers(bank, order, graph=g, lmax=filt.lmax)
    w_y = wop.apply(y, backend="halo", mesh=mesh)  # (eta, N)
    a_back = wop.adjoint(w_y, backend="halo", mesh=mesh)
    gram = wop.gram(y, backend="halo", mesh=mesh)
    gram_err = float(torch.max(torch.abs(a_back - gram)))
    print(f"max |Phi*~(Phi~ y) - gram(y)| on mesh = {gram_err:.2e}")
    if gram_err >= 1e-3:
        raise AssertionError(f"adjoint of apply vs gram: {gram_err}")
    lhs = float(torch.sum(w_y * w_y))
    rhs = float(torch.sum(y * a_back))
    if not abs(lhs - rhs) < 1e-2 * abs(lhs):
        raise AssertionError(f"adjoint identity {lhs} vs {rhs}")
    print(f"adjoint identity on mesh: <Wy,Wy>={lhs:.4f} == <y,W*Wy>={rhs:.4f}")
    print("OK")
    return {
        "n_edges": g.n_edges,
        "words": words,
        "radio_words": paper_words,
        "errs": errs,
        "noisy_mse": noisy_mse,
        "denoised_mse": den_mse,
        "gram_err": gram_err,
        "exchanges": dict(mesh.calls),
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--n-parts", type=int, default=8)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    main(args.device, args.n_parts, args.seed)
