"""Logical-axis sharding: MaxText-style indirection between model code and
mesh layout.

Mirrors ``repro/models/sharding.py``. Model code annotates *parameters*
with logical axes ('d_model', 'heads', 'ffn', 'vocab', 'experts', ...) and
*activations* with 'act_*' axes. A ``ShardingRules`` mapping resolves
logical names to physical mesh axes ('pod' / 'data' / 'model' / None).

``ShardingRules.physical`` returns a plain tuple of mesh-axis entries,
one per dimension (what a jax ``PartitionSpec`` would hold): ``None``, an
axis name, or a tuple of axis names. The rule-sets, the divisibility
check and the spec trees are the reference's, so a later multi-card
placement can read them.

**One-device meaning of ``constrain``.** The port runs a model on one
device, where every tensor is whole, so ``constrain`` is the identity
whatever the rules: it returns its input unchanged and places nothing.
The reference's ``with_sharding_constraint`` only steers GSPMD's layout
and never changes values, so the identity computes the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

__all__ = ["ShardingRules", "make_rules", "logical_to_physical", "constrain",
           "is_spec", "stack_specs"]


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping: logical axis name -> physical mesh axis (or tuple / None)."""

    rules: Mapping[str, Any]
    axis_sizes: Mapping[str, int] | None = None

    def physical(self, logical: Sequence[str | None],
                 shape: Sequence[int] | None = None) -> tuple:
        out = []
        used: set[str] = set()
        for i, name in enumerate(logical):
            entry = self.rules.get(name) if name is not None else None
            axes = _axes_of(entry)
            # drop axes already used by an earlier dim (GSPMD forbids reuse)
            axes = tuple(a for a in axes if a not in used)
            if shape is not None and self.axis_sizes and axes:
                # greedily keep the longest prefix of axes whose cumulative
                # product divides the dim (e.g. 384 experts shard over
                # model=16 but not model x data=256).
                kept = []
                total = 1
                for a in axes:
                    nxt = total * self.axis_sizes.get(a, 1)
                    if nxt and shape[i] % nxt == 0:
                        kept.append(a)
                        total = nxt
                    else:
                        break
                axes = tuple(kept)
            used.update(axes)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(axes)
        return tuple(out)


def make_rules(
    *,
    axis_sizes: Mapping[str, int] | None = None,
    fsdp: bool = False,
    seq_parallel: bool = False,
    shard_kv_seq: bool = False,
    expert_data_parallel: bool = False,
) -> ShardingRules:
    """Build a rule-set for one (mesh x strategy) combination."""
    present = tuple(a for a in ("pod", "data", "model")
                    if not axis_sizes or a in axis_sizes)
    dp_axes = tuple(a for a in ("pod", "data") if a in present)
    rules = {
        # ---- parameters ----
        "d_model": dp_axes if fsdp else None,   # FSDP shard dim
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "expert_ffn": None,
        "conv_kernel": None,
        "state": None,
        "p_layers": None,
        # ---- activations ----
        "act_batch": dp_axes,
        "act_seq": "model" if seq_parallel else None,
        # decode KV: batch takes the DP axes first; the sequence dim takes
        # whatever remains (the order-sensitive dedup in physical()
        # resolves conflicts).
        "act_kv_seq": present if shard_kv_seq else None,
        "act_kv_batch": dp_axes,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_ffn": "model",
        "act_vocab": "model",
        "act_experts": "model",
        "act_moe_group": dp_axes,
        "act_dmodel": None,
    }
    if expert_data_parallel:
        # kimi-scale MoE: 384 experts over model x data.
        rules["experts"] = ("model",) + (("data",) if not fsdp else ())
    return ShardingRules(rules=rules, axis_sizes=axis_sizes)


def is_spec(x) -> bool:
    """A logical spec leaf: tuple of axis names / None (may be empty)."""
    return isinstance(x, tuple) and all(
        n is None or isinstance(n, str) for n in x)


def _map_specs(fn, specs, *rest):
    """``fn`` on every spec leaf of ``specs`` (and the leaves of ``rest``
    at the same places)."""
    if is_spec(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], *(r[k] for r in rest)) for k in specs}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, s, *(r[i] for r in rest))
                           for i, s in enumerate(specs))
    raise TypeError(f"not a spec tree node: {specs!r}")


def logical_to_physical(tree_specs, rules: ShardingRules, tree_shapes=None):
    """Map a tree of logical-name tuples to physical spec tuples.

    If ``tree_shapes`` (a matching tree of tensors, or of anything with a
    ``shape``) is given, divisibility is enforced per-dimension.
    """
    if tree_shapes is None:
        return _map_specs(lambda s: rules.physical(s), tree_specs)
    return _map_specs(lambda s, a: rules.physical(s, a.shape), tree_specs, tree_shapes)


def constrain(x, rules: ShardingRules | None, *logical: str | None):
    """Annotate an activation with a logical sharding constraint: on one
    device, the identity (see the module docstring)."""
    return x


def stack_specs(specs):
    """Prepend the scanned-layer axis to every spec in a group."""
    return _map_specs(lambda s: ("p_layers",) + s, specs)
