"""Chebyshev-gossip gradient consensus on a ring of ranks (the paper's
technique turned on the training cluster).

Mirrors ``examples/gossip_consensus.py``. Eight ranks stacked on one
device (``StackedMesh(8)``) form a ring; each holds its own "gradient"
tree, and Chebyshev gossip approximates the mean with neighbour exchanges
only. Checks, as the reference example does:

  * at orders 2-16 the consensus error, relative to the initial
    disagreement in the aggregate 2-norm, is at most 1.05 x the minimax
    contraction bound 1 / T_M(t0);
  * at M = 12, packed into 2 buckets, the measured words per rank equal
    the analytic ``gossip_message_words(M, 8, n) // 8`` exactly with f32
    payloads and half of it (within 1) with bf16 payloads, and the bf16
    error stays within ``payload_roundoff_bound(M)``;

and, beside them, that the bucketed f32 result equals the per-leaf one
bit for bit.

Run:  PYTHONPATH=src python -m repro_torch.gossip_consensus [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import gossip
from repro_torch.core.collectives import StackedMesh
from repro_torch.device import resolve_device
from repro_torch.train import build_bucket_plan, pack_buckets, unpack_buckets
from repro_torch.tree import tree_map

N_RANKS, BUCKET_ORDER = 8, 12


def sync_bucketed(grads: dict, mesh, n_buckets: int, order: int, payload_dtype=None) -> dict:
    """Gossip ``grads`` (leaves with a leading rank axis) packed into
    ``n_buckets`` flat f32 buffers, one recurrence per bucket."""
    plan = build_bucket_plan(tree_map(lambda g: g[0], grads), n_buckets)
    flats = pack_buckets(plan, grads)
    outs = [gossip.chebyshev_gossip_mean(f, mesh, order=order, payload_dtype=payload_dtype)
            for f in flats]
    return unpack_buckets(plan, outs)


def disagreement(tree: dict, mean: dict) -> float:
    """Aggregate 2-norm of ``tree - mean`` over every rank and leaf: the
    norm the minimax contraction bounds (per-entry ratios can exceed it)."""
    return float(torch.sqrt(sum(((tree[k] - mean[k][None]) ** 2).sum() for k in tree)))


def main(device: str | None = None, seed: int = 0) -> dict:
    dev = resolve_device(device)
    mesh = StackedMesh(N_RANKS, dev)
    gen = torch.Generator().manual_seed(seed)
    # One fake gradient tree per rank (leading axis = rank).
    grads = {
        "w": torch.randn(N_RANKS, 64, 32, generator=gen).to(dev),
        "b": torch.randn(N_RANKS, 32, generator=gen).to(dev),
    }
    exact_mean = {k: g.mean(dim=0) for k, g in grads.items()}
    init = disagreement(grads, exact_mean)
    n_params = 64 * 32 + 32

    print(f"{'M':>3} {'observed':>12} {'bound':>12} {'words/sync':>12}")
    lam1, lmax = gossip.ring_spectrum_bounds(N_RANKS)
    orders = {}
    for order in (2, 4, 6, 8, 12, 16):
        out = gossip.chebyshev_gossip_mean(grads, mesh, order=order)
        rel = disagreement(out, exact_mean) / init
        bound = gossip.consensus_contraction(order, lam1, lmax)
        words = gossip.gossip_message_words(order, N_RANKS, n_params)
        print(f"{order:3d} {rel:12.2e} {bound:12.2e} {words:12d}")
        if rel > bound * 1.05:
            raise AssertionError(f"contraction bound violated at M={order}: {rel} > {bound}")
        orders[order] = (rel, bound)

    ar_words = gossip.allreduce_message_words(N_RANKS, n_params) * N_RANKS
    print(f"ring all-reduce reference words = {ar_words}")
    print(f"required_order(P=8, eps=1e-3) = {gossip.required_order(8, 1e-3)}")
    print(f"required_order(P=16, eps=1e-3) = {gossip.required_order(16, 1e-3)}")

    # Bucketed pipeline and bf16 payloads: words measured on the mesh's
    # ring counter, against the analytic model.
    order = BUCKET_ORDER
    analytic = gossip.gossip_message_words(order, N_RANKS, n_params) // N_RANKS
    serial = gossip.chebyshev_gossip_mean(grads, mesh, order=order)
    print(f"\n{'schedule':>16} {'rel err':>12} {'words/dev':>12} {'analytic':>12}")
    bucketed = {}
    for label, pdt in (("bucketed f32", None), ("bucketed bf16", "bfloat16")):
        out = {}
        measured = gossip.measured_ppermute_words(
            mesh, lambda: out.update(sync_bucketed(grads, mesh, 2, order, pdt)))
        rel = disagreement(out, exact_mean) / init
        print(f"{label:>16} {rel:12.2e} {measured:12d} {analytic:12d}")
        if pdt is None:
            if measured != analytic:
                raise AssertionError(f"f32 words {measured} != analytic {analytic}")
            same = all(torch.equal(out[k], serial[k]) for k in grads)
            if not same:
                raise AssertionError("bucketed f32 gossip differs from per-leaf gossip")
        else:
            if abs(measured - analytic / 2) > 1:
                raise AssertionError(f"bf16 words {measured} != analytic / 2 = {analytic / 2}")
            if rel > gossip.payload_roundoff_bound(order):
                raise AssertionError(f"bf16 error {rel} > {gossip.payload_roundoff_bound(order)}")
        bucketed[label] = {"rel_err": rel, "words": measured}
    print("OK")
    return {
        "orders": orders,
        "analytic_words": analytic,
        "bucketed": bucketed,
        "allreduce_words": ar_words,
        "required_order_8": gossip.required_order(8, 1e-3),
        "n_params": n_params,
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(args.device, args.seed)
