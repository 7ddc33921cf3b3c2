"""Size-balanced gradient buckets for pipelined gossip sync.

Mirrors ``repro/train/buckets.py``. The per-leaf gossip schedule sends
``2 * n_leaves`` neighbour messages per Chebyshev round; a
:class:`BucketPlan` packs the leaves into K flat, size-balanced f32
buffers so each round sends ``2 * K`` large messages instead.

Greedy longest-processing-time assignment (leaves sorted by size, each to
the currently lightest bucket, ties to the lowest index) gives the
reference's buckets exactly: leaves are numbered in ``repro_torch.tree``'s
flat order, which is jax's (dict keys sorted).

The port's tensors may carry leading axes the plan does not see (the
rank axis of a ``StackedMesh``): build the plan from one rank's leaves,
and packing keeps the leading axes each leaf has beyond its planned
shape, so each bucket is ``(P, size)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["BucketPlan", "build_bucket_plan", "pack_buckets", "unpack_buckets"]


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static description of a leaf -> bucket packing.

    ``buckets[b]`` lists flat-leaf indices in pack order; ``sizes[b]`` is
    the bucket's total element count.
    """

    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[Any, ...]
    buckets: tuple[tuple[int, ...], ...]
    sizes: tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    @property
    def n_params(self) -> int:
        return sum(self.sizes)

    def imbalance(self) -> float:
        """max bucket size / mean bucket size (1.0 = perfectly balanced)."""
        if not self.sizes:
            return 1.0
        return max(self.sizes) / (sum(self.sizes) / len(self.sizes))


def build_bucket_plan(tree: Any, n_buckets: int) -> BucketPlan:
    """Greedy size-balanced partition of ``tree``'s leaves into
    ``n_buckets`` buckets.

    Leaves are anything with ``.shape`` and ``.dtype`` (tensors, or
    ``torch.empty(shape, device="meta")``). Buckets never split a leaf;
    with fewer leaves than buckets the plan has one leaf per bucket.
    """
    leaves, treedef = tree_flatten(tree)
    if n_buckets < 1:
        raise ValueError(f"n_buckets={n_buckets} must be >= 1")
    n_buckets = min(n_buckets, len(leaves))
    sizes = [math.prod(lf.shape) for lf in leaves]
    order = sorted(range(len(leaves)), key=lambda i: -sizes[i])
    assignment: list[list[int]] = [[] for _ in range(n_buckets)]
    fill = [0] * n_buckets
    for i in order:
        b = fill.index(min(fill))
        assignment[b].append(i)
        fill[b] += sizes[i]
    return BucketPlan(
        treedef=treedef,
        shapes=tuple(tuple(lf.shape) for lf in leaves),
        dtypes=tuple(lf.dtype for lf in leaves),
        buckets=tuple(tuple(b) for b in assignment),
        sizes=tuple(fill),
    )


def pack_buckets(plan: BucketPlan, tree: Any) -> list[torch.Tensor]:
    """Flatten ``tree`` into ``plan.n_buckets`` contiguous f32 buffers,
    each ``lead + (size,)``: ``lead`` is the leading axes every leaf has
    in front of its planned shape (none for a tree like the plan's)."""
    leaves = tree_leaves(tree)
    if len(leaves) != plan.n_leaves:
        raise ValueError(f"tree has {len(leaves)} leaves, plan expects {plan.n_leaves}")
    leads = {tuple(lf.shape[:lf.dim() - len(s)]) for lf, s in zip(leaves, plan.shapes)}
    if len(leads) > 1 or any(tuple(lf.shape[lf.dim() - len(s):]) != s
                             for lf, s in zip(leaves, plan.shapes)):
        raise ValueError("leaf shapes do not end in the plan's shapes under one leading shape")
    lead = leads.pop() if leads else ()
    return [
        torch.cat([leaves[i].to(torch.float32).reshape(lead + (-1,)) for i in idxs], dim=-1)
        for idxs in plan.buckets
    ]


def unpack_buckets(plan: BucketPlan, flats: list[torch.Tensor]) -> Any:
    """Inverse of :func:`pack_buckets` (restores shapes, dtypes and the
    leading axes)."""
    out: list[Any] = [None] * plan.n_leaves
    for idxs, flat in zip(plan.buckets, flats):
        lead = tuple(flat.shape[:-1])
        off = 0
        for i in idxs:
            n = math.prod(plan.shapes[i])
            out[i] = flat[..., off:off + n].reshape(lead + plan.shapes[i]).to(plan.dtypes[i])
            off += n
    return tree_unflatten(plan.treedef, out)
