"""Trip-count-weighted cost analysis of one step, from an aten op trace.

Mirrors ``repro/launch/hlo_weighted.py``. The reference parses XLA's
partitioned HLO text, weights each ``while`` body by its trip count and
sums matmul FLOPs, HBM bytes at fusion boundaries and collective operand
bytes. Torch has no HLO: :func:`analyze_step` runs the step once under a
``TorchDispatchMode`` and sees every aten op it dispatches. On ``meta``
tensors (the dry run) no array is materialised and nothing is computed;
on real tensors the same counts come out beside the real results.

Per op it counts:

* **matmul FLOPs**: 2 x output elements x contracted elements of every
  matmul-like op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  the fused attention ops), from ``torch.utils.flop_counter``'s formulas.
  Elementwise FLOPs are not counted, as in the reference (``_dot_flops``).
* **HBM bytes**: every tensor operand and output of every op that is not a
  view or an allocation (the counterpart of ``_FREE_OPS``). Eager torch
  fuses nothing, so each op boundary is a trip through memory: this is
  the port's real eager traffic, where the reference counts at XLA's
  fusion boundaries. An expanded operand counts its distinct elements.
  An op that writes into an argument (its schema marks it written) is
  charged what it reads and what it writes: an indexed write
  (``index_copy_``, ``index_add_``, ``index_put_``) writes its update, not
  its destination (the reference's dynamic-update-slice at twice the
  update's size); ``copy_``, ``fill_``, ``zero_`` and an ``out=`` argument
  are written without being read; any other in-place op reads and writes
  its destination.
* **peak live bytes**: storages that ops make during the step (not the
  arguments'), added when an op returns a storage none of its inputs had
  and dropped when the last reference to it goes: the counterpart of
  ``memory_analysis().temp_size_in_bytes``.
* an op histogram (``op_counts``), which ``launch.roofline.count_ops``
  reads.

A single-device trace has no collectives: ``collective_bytes`` starts at
zero for the reference's opcodes, and ``launch.comm`` fills them from a
model of what the sharding rules imply.

**Trip counts.** The port's loops run in Python, so a trace is already
weighted; it is only slow where a loop is long. :func:`analyze_weighted`
traces a stacked-layer model at one and two repeat groups (and a
microbatched step at two and three microbatches) and extrapolates
linearly: the groups (and microbatches) are identical, so every count is
affine in each, and the two-point extrapolation is exact.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.tree import tree_leaves

__all__ = ["WeightedCosts", "analyze_step", "analyze_weighted", "COLLECTIVES"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# Ops that allocate, alias or read metadata and move no data (views are
# told apart by their schema, ``OpOverload.is_view``).
_FREE_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "alias", "detach", "lift_fresh", "set_", "resize_",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
}
# In-place ops that overwrite their destination without reading it.
_OVERWRITES = {"copy_", "fill_", "zero_"}
# Indexed writes: the argument that holds the update, and whether the op
# also reads the region it updates (an accumulating write; ``None``: as
# its ``accumulate`` argument says).
_INDEXED_WRITES = {"index_copy_": ("source", False), "index_add_": ("source", True),
                   "index_put_": ("values", None)}


@dataclasses.dataclass
class WeightedCosts:
    matmul_flops: float
    hbm_bytes: float
    collective_bytes: dict[str, float]
    while_trip_counts: list[int]
    collective_rounds: dict[str, float] = dataclasses.field(default_factory=dict)
    peak_live_bytes: float = 0.0
    op_counts: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))


def _zero() -> WeightedCosts:
    return WeightedCosts(0.0, 0.0, {k: 0.0 for k in COLLECTIVES}, [],
                         {k: 0.0 for k in COLLECTIVES})


def _combine(terms: list[tuple[float, WeightedCosts]]) -> WeightedCosts:
    """``sum(w * costs)`` field by field."""
    out = _zero()
    ops: Counter = Counter()
    for w, c in terms:
        out.matmul_flops += w * c.matmul_flops
        out.hbm_bytes += w * c.hbm_bytes
        out.peak_live_bytes += w * c.peak_live_bytes
        for k, v in c.collective_bytes.items():
            out.collective_bytes[k] = out.collective_bytes.get(k, 0.0) + w * v
        for k, v in c.collective_rounds.items():
            out.collective_rounds[k] = out.collective_rounds.get(k, 0.0) + w * v
        for k, v in c.op_counts.items():
            ops[k] += w * v
    out.op_counts = {k: v for k, v in ops.items() if abs(v) > 1e-9}
    return out


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses (an expanded,
    stride-0 dimension reads its elements once)."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def _op_bytes(func, args, kwargs, out) -> int:
    """Bytes one op moves: its tensor operands read and its outputs
    written, with a written argument charged as the module docstring
    says."""
    arguments = func._schema.arguments
    written = [a for a in arguments if a.alias_info is not None and a.alias_info.is_write]
    if not written:
        return sum(_distinct_bytes(t) for t in _tensors(args) + _tensors(kwargs) + _tensors(out))
    bound = {a.name: args[i] if i < len(args) else kwargs.get(a.name)
             for i, a in enumerate(arguments)}
    dests = {id(t) for a in written for t in _tensors(bound[a.name])}
    total = sum(_distinct_bytes(t) for t in _tensors(args) + _tensors(kwargs)
                if id(t) not in dests)
    name = func.overloadpacket.__name__
    for a in written:
        for t in _tensors(bound[a.name]):
            if name in _INDEXED_WRITES:
                update, reads = _INDEXED_WRITES[name]
                if reads is None:
                    reads = bool(bound["accumulate"])
                total += _distinct_bytes(bound[update]) * (2 if reads else 1)
            elif a.kwarg_only or name in _OVERWRITES:
                total += _distinct_bytes(t)
            else:
                total += 2 * _distinct_bytes(t)
    return total


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _CostMode(TorchDispatchMode):
    """Counts matmul FLOPs, op-boundary bytes, ops and live storages."""

    def __init__(self, arg_storages: set[int]):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops: Counter = Counter()
        self.live = 0
        self.peak = 0
        self.known = set(arg_storages)
        self.finalizers: dict[int, weakref.finalize] = {}

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self.known.discard(key)
        self.finalizers.pop(key, None)

    def _track(self, t: torch.Tensor, input_keys: set[int]) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.known or key in input_keys:
            return
        self.known.add(key)
        nbytes = storage.nbytes()
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        self.finalizers[key] = weakref.finalize(storage, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        self.ops[func.__name__] += 1
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        inputs = _tensors(args) + _tensors(kwargs)
        outputs = _tensors(out)
        if not (func.is_view or packet.__name__ in _FREE_OPS):
            self.bytes += _op_bytes(func, args, kwargs, out)
        input_keys = {_storage_key(t) for t in inputs}
        for t in outputs:
            self._track(t, input_keys)
        return out

    def close(self) -> None:
        for fin in list(self.finalizers.values()):
            fin.detach()
        self.finalizers.clear()


def analyze_step(fn: Callable, *args, **kwargs) -> WeightedCosts:
    """Run ``fn(*args, **kwargs)`` once under the counting mode and return
    its costs. Pass ``meta`` tensors to analyse without computing (every op
    of the step must then have a meta kernel and read no value: no
    ``.item()``, no ``float(loss)``). ``while_trip_counts`` is empty: a
    single trace runs every loop in full."""
    arg_keys = {_storage_key(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
    mode = _CostMode(arg_keys)
    try:
        with mode:
            result = fn(*args, **kwargs)
        del result
    finally:
        mode.close()
    costs = _zero()
    costs.matmul_flops = mode.flops
    costs.hbm_bytes = mode.bytes
    costs.peak_live_bytes = float(mode.peak)
    costs.op_counts = dict(mode.ops)
    return costs


def _line_weights(target: int, points: list[int]) -> list[tuple[int, float]]:
    """Weights of the linear function through ``points`` at ``target``."""
    if len(points) == 1:
        return [(points[0], 1.0)]
    x0, x1 = points
    return [(x0, (x1 - target) / (x1 - x0)), (x1, (target - x0) / (x1 - x0))]


def analyze_weighted(build: Callable[[int, int], tuple[Callable, tuple]], *, repeats: int,
                     microbatches: int = 1) -> WeightedCosts:
    """Costs of a step with ``repeats`` stacked groups and ``microbatches``
    microbatches, from traces at one and two groups (all of them when
    ``repeats <= 2``) and, for more than two microbatches, at two and three.

    ``build(groups, micro) -> (fn, args)`` makes the step at that size. A
    stacked-layer step costs ``a + b g`` in the group count ``g`` (the
    prefix layers and the head are in ``a``); a step of ``m >= 2``
    microbatches costs ``c + d m`` (one microbatch takes the unaccumulated
    path, so two and three are the points), and ``a, b`` are themselves
    affine in ``m``: the product of the two line fits is exact for every
    count. ``peak_live_bytes`` is extrapolated the same way, which holds
    where the peak falls at the same point of every trace (held against
    full traces in ``tests/test_torch_launch.py``).
    ``while_trip_counts`` records the multipliers, largest first."""
    g_points = [repeats] if repeats <= 2 else [1, 2]
    m_points = [microbatches] if microbatches <= 2 else [2, 3]
    terms = []
    for g, wg in _line_weights(repeats, g_points):
        for m, wm in _line_weights(microbatches, m_points):
            fn, args = build(g, m)
            terms.append((wg * wm, analyze_step(fn, *args)))
    out = _combine(terms)
    out.while_trip_counts = sorted((t for t in (repeats, microbatches) if t > 1), reverse=True)
    return out
