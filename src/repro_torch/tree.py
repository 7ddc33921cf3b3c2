"""Pytrees of tensors: nested dicts, lists and tuples, flattened in the
order ``jax.tree_util`` uses.

The reference flattens its gradient, parameter and optimiser trees with
``jax.tree_util`` (``repro/train/buckets.py``, ``repro/optim/adamw.py``,
``repro/checkpoint/store.py``). Bucket plans name leaves by their flat
index and checkpoints by their key path, so the port must flatten in the
same order: dict keys *sorted* (``torch.utils._pytree`` keeps insertion
order instead), lists and tuples by position. ``None`` is an empty
subtree, as in jax; everything else is a leaf.

Key paths join the parts with ``/``: a dict key as ``str(key)``, a list or
tuple index as its digits (``repro/checkpoint/store.py:59-72``).
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["TreeDef", "tree_flatten", "tree_flatten_with_path", "tree_leaves",
           "tree_map", "tree_unflatten"]

_LEAF = "*"
_END = object()


class TreeDef:
    """The structure of a flattened tree: a node's type, its dict keys
    (sorted) and its children's structures; ``*`` marks a leaf."""

    def __init__(self, kind: Any, keys: tuple = (), children: tuple = ()):
        self.kind = kind  # _LEAF, None, dict, or a list / tuple type
        self.keys = keys
        self.children = children

    def unflatten(self, leaves) -> Any:
        return tree_unflatten(self, leaves)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.keys == other.keys and self.children == other.children)

    def _body(self) -> str:
        if self.kind == _LEAF:
            return "*"
        if self.kind is None:
            return "None"
        parts = [c._body() for c in self.children]
        if self.kind is dict:
            return "{" + ", ".join(f"{k!r}: {p}" for k, p in zip(self.keys, parts)) + "}"
        if issubclass(self.kind, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"

    def __str__(self) -> str:
        # jax's spelling, so a manifest's "treedef" reads the same from
        # either package.
        return f"PyTreeDef({self._body()})"

    __repr__ = __str__


def _flatten(tree, path: tuple, leaves: list, paths: list) -> TreeDef:
    if tree is None:
        return TreeDef(None)
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        kids = tuple(_flatten(tree[k], path + (str(k),), leaves, paths) for k in keys)
        return TreeDef(dict, keys, kids)
    if isinstance(tree, (list, tuple)):
        kids = tuple(_flatten(v, path + (str(i),), leaves, paths) for i, v in enumerate(tree))
        return TreeDef(type(tree), (), kids)
    leaves.append(tree)
    paths.append("/".join(path))
    return TreeDef(_LEAF)


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` in jax's order (dict keys sorted)."""
    leaves: list = []
    treedef = _flatten(tree, (), leaves, [])
    return leaves, treedef


def tree_flatten_with_path(tree) -> tuple[list[tuple[str, Any]], TreeDef]:
    """``([(key_path, leaf), ...], treedef)``: each leaf beside its
    ``/``-joined key path, in the order of :func:`tree_flatten`."""
    leaves: list = []
    paths: list = []
    treedef = _flatten(tree, (), leaves, paths)
    return list(zip(paths, leaves)), treedef


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """Rebuild the tree of ``treedef`` from ``leaves`` (in flat order)."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == _LEAF:
            return next(it)
        if td.kind is None:
            return None
        kids = [build(c) for c in td.children]
        if td.kind is dict:
            return dict(zip(td.keys, kids))
        if td.kind in (list, tuple):
            return td.kind(kids)
        return td.kind(*kids) if hasattr(td.kind, "_fields") else td.kind(kids)

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError(f"too many leaves for {treedef}")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leafwise; ``rest`` are trees of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for r_leaves, r_def in others:
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {r_def}")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *(o[0] for o in others))])
