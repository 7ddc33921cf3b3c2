"""A model of the collectives that a cell's sharding rules imply.

No file of its own in the reference: there, XLA's SPMD partitioner inserts
the collectives and ``repro/launch/hlo_analysis.py::parse_collective_bytes``
reads them from the partitioned HLO. Torch has no partitioner, so this
module states what a partitioned step would move, term by term, from the
cell's ``ShardingRules`` and shapes. It is a model, not a measurement: its
numbers differ from the reference's, which count what XLA chose to insert
(its fusions, its resharding copies, its choice of all-gather or
all-reduce).

Bytes are operand bytes per device, as the reference counts them, except
all-gathers, which count the gathered output (the reference's counter
does the same: a ring all-gather pushes about its output through each
link). Every element's width is capped at the model's activation width
(``activation_dtype``), as the reference caps collective widths (the
gossip payload, whose dtype is chosen, excepted); in the
port that cap applies to collectives only, because the port's bf16 stays
bf16 everywhere else. A "pass" is one forward, one remat recompute or one
backward over a microbatch.

Terms, each a function below: :func:`fsdp`, :func:`data_parallel`,
:func:`tensor_parallel`, :func:`moe_all_to_all` and :func:`gossip_sync`;
:func:`step_collectives` adds them up for one step. ``seq_parallel`` and
the decode KV sequence shards move no extra term here.
"""

from __future__ import annotations

import math

from repro_torch.core import gossip
from repro_torch.launch.op_costs import COLLECTIVES
from repro_torch.models.config import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.models.moe import group_capacity
from repro_torch.models.sharding import ShardingRules

__all__ = ["DP_AXES", "spec_axes", "fsdp", "data_parallel", "tensor_parallel",
           "moe_all_to_all", "gossip_sync", "step_collectives", "flat_specs"]

DP_AXES = ("pod", "data")


def spec_axes(spec) -> tuple[str, ...]:
    """The mesh axes a physical spec (``ShardingRules.physical``) uses."""
    out: list[str] = []
    for entry in spec:
        if entry is None:
            continue
        out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def _is_physical(x) -> bool:
    """A physical spec leaf: a tuple of None, axis names or tuples of them."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and e and all(
            isinstance(a, str) for a in e)) for e in x)


def flat_specs(phys) -> list:
    """The spec leaves of a physical spec tree, in ``tree_leaves`` order
    (dict keys sorted)."""
    if _is_physical(phys):
        return [phys]
    if isinstance(phys, dict):
        return [s for k in sorted(phys) for s in flat_specs(phys[k])]
    return [s for v in phys for s in flat_specs(v)]


def _shards(spec, sizes, axes=None) -> int:
    return math.prod(sizes.get(a, 1) for a in spec_axes(spec) if axes is None or a in axes)


def _width(t, width: int) -> int:
    return min(t.element_size(), width)


def _passes(train: bool, remat: bool) -> int:
    """Forward, recompute and backward passes per microbatch."""
    return (2 + remat) if train else 1


def fsdp(leaves, specs, sizes, *, train: bool, remat: bool, microbatches: int,
         width: int) -> tuple[dict, dict]:
    """FSDP: every leaf sharded over a data-parallel axis is all-gathered
    over those axes before each forward use (once per microbatch, once
    more per microbatch under remat) and, in training, its gradient is
    reduce-scattered back once per microbatch. Bytes per device: the
    leaf gathered over the data axes and still split over the others."""
    ag = rs = n_ag = n_rs = 0.0
    uses = microbatches * (1 + (train and remat))
    for t, spec in zip(leaves, specs):
        if _shards(spec, sizes, DP_AXES) == 1:
            continue
        gathered = t.numel() * _width(t, width) / _shards(spec, sizes, None) \
            * _shards(spec, sizes, DP_AXES)
        ag += uses * gathered
        n_ag += uses
        if train:
            rs += microbatches * gathered
            n_rs += microbatches
    return {"all-gather": ag, "reduce-scatter": rs}, {"all-gather": n_ag, "reduce-scatter": n_rs}


def data_parallel(leaves, specs, sizes, *, width: int) -> tuple[dict, dict]:
    """Plain data parallelism (training without FSDP): one all-reduce of
    each leaf's gradient per step, after the microbatches are summed
    locally. Bytes per device: the leaf's local (model-split) gradient."""
    nbytes = sum(t.numel() * _width(t, width) / _shards(spec, sizes) for t, spec in
                 zip(leaves, specs))
    return {"all-reduce": nbytes}, {"all-reduce": float(len(leaves))}


def _activation_bytes(rules: ShardingRules, batch: int, seq: int, d: int, width: int) -> float:
    """Per-device bytes of one (batch, seq, d) activation as the rules
    place it (``act_batch`` over the data axes, ``act_seq``)."""
    spec = rules.physical(("act_batch", "act_seq", None), (batch, seq, d))
    return batch * seq * d * width / _shards(spec, rules.axis_sizes or {})


def tensor_parallel(n_tp_blocks: int, act_bytes: float, *, train: bool,
                    remat: bool) -> tuple[dict, dict]:
    """Tensor parallelism: two all-reduces of the block's output
    activation (after the mixing layer and after the FFN) per block whose
    weights the rules split on ``model``, in every pass. ``act_bytes`` is
    the whole step's activation per device (all microbatches), so the
    microbatch count drops out."""
    passes = _passes(train, remat)
    return ({"all-reduce": 2.0 * n_tp_blocks * passes * act_bytes},
            {"all-reduce": 2.0 * n_tp_blocks * passes})


def moe_all_to_all(n_moe_layers: int, cfg: ModelConfig, par: ParallelConfig,
                   rules: ShardingRules, tokens_per_micro: int, *, microbatches: int,
                   train: bool, remat: bool, width: int) -> tuple[dict, dict]:
    """MoE with the experts on ``model``: two all-to-alls of the
    dispatched tokens (dispatch and combine) per MoE layer per pass.
    Bytes per device: the ``(groups, experts, capacity, d)`` dispatch
    buffer as the rules place it."""
    moe = cfg.moe
    g, cap = group_capacity(tokens_per_micro, par.moe_groups, moe.top_k, moe.n_experts,
                            par.moe_capacity or moe.capacity_factor)
    shape = (g, cfg.moe.n_experts, cap, cfg.d_model)
    spec = rules.physical(("act_moe_group", "act_experts", None, None), shape)
    buf = math.prod(shape) * width / _shards(spec, rules.axis_sizes or {})
    n = 2.0 * n_moe_layers * microbatches * _passes(train, remat)
    return {"all-to-all": n * buf}, {"all-to-all": n}


def gossip_sync(n_local_params: int, axis_size: int, par: ParallelConfig) -> tuple[dict, dict]:
    """``grad_sync="gossip"``: Chebyshev gossip over the ``data`` ring,
    ``core.gossip.gossip_message_words`` per sync for all ranks (M rounds,
    each sending the local gradient to both ring neighbours), so per
    device that over the ring's size. One sync per step, or one per
    microbatch in the delay-slot schedule (``gossip_overlap``). The
    payload's width is ``gossip_payload_dtype``'s (f32 by default), not
    capped: the wire format is chosen, not promoted."""
    order = par.gossip_order or gossip.required_order(axis_size, 1e-3)
    rounds = max(order - par.gossip_truncate, 0)
    itemsize = 2 if par.gossip_payload_dtype == "bfloat16" else 4
    syncs = par.microbatches if (par.gossip_overlap and par.microbatches > 1) else 1
    words = gossip.gossip_message_words(rounds, axis_size, n_local_params) / axis_size
    return ({"collective-permute": syncs * words * itemsize},
            {"collective-permute": syncs * 2.0 * rounds})


def _model_split_layers(cfg: ModelConfig, block_specs, prefix_specs) -> tuple[int, int]:
    """Blocks whose weights are split on ``model``, and MoE layers whose
    experts are: each prefix layer once, each pattern entry ``repeats``
    times."""
    def on_model(tree):
        return any("model" in spec_axes(s) for s in flat_specs(tree))

    tp = sum(on_model(s) for s in prefix_specs)
    tp += cfg.repeats * sum(on_model(s) for s in block_specs)
    moe = sum(1 for (_, f), s in zip(cfg.prefix_layers, prefix_specs)
              if f == "moe" and _experts_on_model(s))
    moe += cfg.repeats * sum(1 for f, s in zip(cfg.ffn_pattern, block_specs)
                             if f == "moe" and _experts_on_model(s))
    return tp, moe


def _experts_on_model(block_spec) -> bool:
    ffn = block_spec.get("ffn", {})
    return "wi_gate" in ffn and "model" in spec_axes(ffn["wi_gate"])


def step_collectives(cfg: ModelConfig, par: ParallelConfig, shape: ShapeConfig,
                     rules: ShardingRules, leaves, specs, phys_tree) -> tuple[dict, dict]:
    """Per-device collective bytes and counts of one step of ``shape``'s
    kind: the sum of the terms above that the cell's rules and
    ``ParallelConfig`` call for. ``leaves`` / ``specs`` are the param
    leaves and their physical specs in flat order; ``phys_tree`` is the
    physical spec tree (its ``prefix`` list and ``blocks`` tuple name the
    layers)."""
    sizes = dict(rules.axis_sizes or {})
    train = shape.kind == "train"
    remat = train and par.remat == "block"
    micro = par.microbatches if train else 1
    width = cfg.dtype().itemsize
    out = {k: 0.0 for k in COLLECTIVES}
    rounds = {k: 0.0 for k in COLLECTIVES}

    def add(term):
        b, n = term
        for k, v in b.items():
            out[k] += v
        for k, v in n.items():
            rounds[k] += v

    if any(_shards(s, sizes, DP_AXES) > 1 for s in specs):
        add(fsdp(leaves, specs, sizes, train=train, remat=remat, microbatches=micro,
                 width=width))
    elif train and par.grad_sync == "allreduce":
        add(data_parallel(leaves, specs, sizes, width=width))
    if train and par.grad_sync == "gossip":
        local = sum(t.numel() / _shards(s, sizes) for t, s in zip(leaves, specs))
        add(gossip_sync(int(local), sizes.get("data", 1), par))
    seq = 1 if shape.kind == "decode" else shape.seq_len
    tokens = shape.global_batch * seq
    n_tp, n_moe = _model_split_layers(cfg, list(phys_tree["blocks"]),
                                      list(phys_tree.get("prefix", [])))
    act = _activation_bytes(rules, shape.global_batch, seq, cfg.d_model, width)
    add(tensor_parallel(n_tp, act, train=train, remat=remat))
    if n_moe:
        add(moe_all_to_all(n_moe, cfg, par, rules, tokens // micro, microbatches=micro,
                           train=train, remat=remat, width=width))
    return out, rounds
