"""Dry run: trace every (architecture x shape x mesh) cell's step on
``meta`` tensors and extract the roofline terms.

Mirrors ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell against the production meshes on 512 forced host devices and reads
the partitioned HLO. The port has neither HLO nor an SPMD partitioner; it
runs the port's own step once per traced size on ``meta`` tensors (no
array is materialised, nothing is compiled, no card is needed: the dry
run takes no ``--device``, as the reference's runs on fake host devices)
and reads the aten op trace (``launch.op_costs``).

Per-device numbers, under ``"partition": "ideal"`` in each record:

* parameter, AdamW, cache and batch bytes per device are exact: each
  leaf's bytes over the product of the axis sizes in its physical spec
  (``ShardingRules.physical``, which enforces divisibility); they fill
  ``memory.argument_bytes``;
* FLOPs, HBM bytes and peak live bytes of the traced global program are
  divided by the card count (one data-parallel rank's program over the
  ``model`` axis for a gossip cell, which traces one rank);
* collectives come from the model in ``launch.comm``, not from a
  partitioner: the numbers differ from the reference's.

The trace does not depend on the mesh except through ``moe_groups``,
which follows the data-parallel size, so ``--both-meshes`` traces each
cell once and reuses it, except a MoE arch's, which it traces per mesh.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_405b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out results.json]
  python -m repro_torch.launch.dryrun --gsp       # the paper's own workload
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Callable

import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import roofline as H
from repro_torch.launch.cells import CELLS, cell_skip_reason, default_parallel, shape_with_frontend
from repro_torch.launch.comm import flat_specs, spec_axes, step_collectives
from repro_torch.launch.donation import DECODE_DONATE, PREFILL_DONATE, TRAIN_DONATE
from repro_torch.launch.mesh import ProductionMesh, axis_sizes, make_production_mesh
from repro_torch.launch.op_costs import COLLECTIVES, WeightedCosts, analyze_step, analyze_weighted
from repro_torch.models import lm
from repro_torch.models.config import ALL_SHAPES, ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.models.sharding import logical_to_physical, make_rules
from repro_torch.optim import AdamWConfig, init_opt_state, opt_state_specs
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import tree_flatten_with_path, tree_leaves

__all__ = ["SHAPES", "param_count", "active_param_count", "input_specs", "at_depth",
           "build_cell", "run_cell", "run_gsp_cell", "trace_costs", "main"]

SHAPES = {s.name: s for s in ALL_SHAPES}
META = torch.device("meta")


# ------------------------------------------------------------ utilities --


def param_count(params) -> int:
    return int(sum(t.numel() for t in tree_leaves(params)))


def active_param_count(cfg: ModelConfig, params) -> int:
    """Matmul-active params: routed experts scaled by top_k/n_experts;
    embedding-table gather excluded for untied embeddings (the logits
    matmul itself is counted via the tied/untied table)."""
    total = param_count(params)
    if cfg.moe is not None:
        paths, _ = tree_flatten_with_path(params)
        routed = sum(
            t.numel() for path, t in paths
            if path.split("/")[-1] in ("wi_gate", "wi_up", "wo")
            and "ffn" in path.split("/") and t.dim() == 4  # stacked (layers, E, d, f)
        )
        total -= routed
        total += int(routed * cfg.moe.top_k / cfg.moe.n_experts)
    if not cfg.tie_embeddings:
        total -= cfg.vocab_size * cfg.d_model  # gather-only table
    return total


def _rough_param_bytes(cfg: ModelConfig) -> float:
    """Cheap parameter-byte estimate (no abstract init needed)."""
    d, l, ff, v = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size
    per_layer = 4 * d * cfg.n_heads * cfg.head_dim_ // cfg.q_per_kv + 3 * d * ff
    if cfg.moe is not None:
        per_layer = 4 * d * d * 2 + 3 * d * cfg.moe.d_expert * (
            cfg.moe.n_experts + cfg.moe.n_shared)
    total = l * per_layer + v * d * (1 if cfg.tie_embeddings else 2)
    return total * cfg.pdtype().itemsize


def input_specs(arch: str, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input of a cell."""
    cfg = registry.get(arch)
    shape = shape_with_frontend(arch, SHAPES[shape_name])
    return make_batch_specs(cfg, shape, dtype=cfg.dtype())


def _device_bytes(tree, phys, sizes) -> float:
    """Bytes per device of a tree of tensors under its physical specs."""
    return sum(t.numel() * t.element_size() / math.prod(sizes.get(a, 1) for a in spec_axes(s))
               for t, s in zip(tree_leaves(tree), flat_specs(phys), strict=True))


def _batch_phys(batch: dict, rules) -> dict:
    return {k: rules.physical(("act_batch",) + (None,) * (v.dim() - 1), v.shape)
            for k, v in batch.items()}


def at_depth(cfg: ModelConfig, groups: int) -> ModelConfig:
    """``cfg`` with ``groups`` repeats of its pattern (prefix kept)."""
    return dataclasses.replace(cfg, n_layers=len(cfg.prefix_layers) + len(cfg.pattern) * groups)


# ------------------------------------------------------------ cell build --


@dataclasses.dataclass
class BuiltCell:
    """What ``build_cell`` decides for one cell: the config, the step
    builder for the trace (``make(groups, micro) -> (fn, args)`` on
    ``meta``; donation as ``launch.donation``'s tables say), per-device
    bytes of each step argument and the memory they sum to, the
    collective model's bytes and counts, and the record's metadata."""

    cfg: ModelConfig
    shape: ShapeConfig
    par: ParallelConfig
    make: Callable[[int, int], tuple[Callable, tuple]]
    rank_split: int            # the traced program is 1 / rank_split of the step
    arguments: dict[str, float]
    memory: dict
    collectives: tuple[dict, dict]
    meta: dict


def build_cell(arch: str, shape: str | ShapeConfig, *, multi_pod: bool = False,
               mesh: ProductionMesh | None = None,
               par: ParallelConfig | None = None) -> BuiltCell:
    """One cell: ``shape`` is a run-matrix shape's name or any
    ``ShapeConfig``, ``mesh`` the production mesh ``multi_pod`` names
    unless given, ``par`` the cell's ``default_parallel`` unless given."""
    cfg = registry.get(arch)
    shape = shape_with_frontend(arch, SHAPES[shape] if isinstance(shape, str) else shape)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    sizes = axis_sizes(mesh)
    n_chips = mesh.size
    par = par or default_parallel(arch, shape)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    if par.moe_groups == 1:
        # one dispatch group per DP shard keeps MoE buffers group-local
        par = dataclasses.replace(par, moe_groups=dp)
    if shape.kind != "train":
        # serving: keep weights TP-resident when a model-axis shard fits
        # (low-latency path); FSDP-gather per layer group otherwise.
        tp_bytes = _rough_param_bytes(cfg) / sizes.get("model", 1)
        par = dataclasses.replace(par, fsdp=tp_bytes > 12 * 2**30)
    rules = make_rules(axis_sizes=sizes, fsdp=par.fsdp, seq_parallel=par.seq_parallel,
                       shard_kv_seq=shape.kind == "decode",
                       expert_data_parallel=cfg.moe is not None and cfg.moe.n_experts > 64)

    p_shapes, p_specs = lm.abstract_init(cfg)
    p_phys = logical_to_physical(p_specs, rules, p_shapes)
    batch_specs = make_batch_specs(cfg, shape, dtype=cfg.dtype())
    n_params = param_count(p_shapes)
    n_active = active_param_count(cfg, p_shapes)
    param_bytes = _device_bytes(p_shapes, p_phys, sizes)
    batch_bytes = _device_bytes(batch_specs, _batch_phys(batch_specs, rules), sizes)
    ranks = 1
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        optc = AdamWConfig(moment_dtype=par.optimizer_dtype)
        o_shapes = init_opt_state(p_shapes, optc)
        o_phys = logical_to_physical(opt_state_specs(p_specs), rules, o_shapes)
        opt_bytes = _device_bytes(o_shapes, o_phys, sizes)
        if par.grad_sync == "gossip":
            # Gossip needs params replicated across 'data' (no FSDP). Each
            # rank's step is the one-device step on its rows plus the
            # sync; trace one rank (launch.comm prices the sync).
            if par.fsdp:
                raise ValueError("gossip sync needs non-FSDP params (set fsdp=false)")
            ranks = sizes.get("data", 1)
        if b % ranks or (b // ranks) % par.microbatches:
            raise ValueError(f"batch {b} does not split into {ranks} ranks x "
                             f"{par.microbatches} microbatches")
        rows = b // ranks // par.microbatches

        def make(groups, micro):
            c = at_depth(cfg, groups)
            params, _ = lm.abstract_init(c)
            opt = init_opt_state(params, optc)
            batch = make_batch_specs(c, dataclasses.replace(shape, global_batch=rows * micro),
                                     dtype=c.dtype())
            step = make_train_step(c, dataclasses.replace(par, microbatches=micro), optc,
                                   rules)
            return ((lambda p, o, bt: step(p, o, bt, donate=bool(TRAIN_DONATE))),
                    (params, opt, batch))

        args, donate = {"params": param_bytes, "opt_state": opt_bytes,
                        "batch": batch_bytes}, TRAIN_DONATE
        out_bytes = param_bytes + opt_bytes
        model_flops = H.model_flops_train(n_active, b * s)
    elif shape.kind == "prefill":
        def make(groups, micro):
            c = at_depth(cfg, groups)
            params, _ = lm.abstract_init(c)
            batch = make_batch_specs(c, shape, dtype=c.dtype())

            def step(p, bt):
                with torch.no_grad():
                    logits, _ = lm.forward(p, bt["tokens"], c, par, rules,
                                           extra_embeds=bt.get("extra_embeds"), last_only=True)
                return logits
            return step, (params, batch)

        args, donate = {"params": param_bytes, "batch": batch_bytes}, PREFILL_DONATE
        out_bytes = _logit_bytes(cfg, rules, b, sizes)
        model_flops = H.model_flops_infer(n_active, b * s)
    else:  # decode
        c_shapes = lm.init_cache(cfg, b, s, cfg.dtype(), META)
        c_phys = logical_to_physical(lm.cache_logical_specs(cfg), rules, c_shapes)
        cache_bytes = _device_bytes(c_shapes, c_phys, sizes)

        def make(groups, micro):
            c = at_depth(cfg, groups)
            params, _ = lm.abstract_init(c)
            cache = lm.init_cache(c, b, s, c.dtype(), META)
            batch = make_batch_specs(c, shape, dtype=c.dtype())

            def step(p, bt, ch):
                with torch.no_grad():
                    return lm.decode_step(p, bt["token"], ch, c, par, rules)
            return step, (params, batch, cache)

        args, donate = {"params": param_bytes, "batch": batch_bytes,
                        "cache": cache_bytes}, DECODE_DONATE
        out_bytes = cache_bytes + _logit_bytes(cfg, rules, b, sizes)
        model_flops = H.model_flops_infer(n_active, b)

    coll = step_collectives(cfg, par, shape, rules, tree_leaves(p_shapes), flat_specs(p_phys),
                            p_phys)
    meta = {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "multi_pod": multi_pod, "n_chips": n_chips,
        "n_params": n_params, "n_params_active": n_active,
        "model_flops": model_flops,
        "parallel": dataclasses.asdict(par),
        "partition": "ideal", "analysis": "aten-trace-meta",
    }
    # donated arguments alias the outputs that replace them
    sizes_in_order = list(args.values())
    memory = {"argument_bytes": sum(sizes_in_order), "output_bytes": out_bytes,
              "alias_bytes": sum(sizes_in_order[i] for i in donate)}
    return BuiltCell(cfg, shape, par, make, ranks, args, memory, coll, meta)


def _logit_bytes(cfg: ModelConfig, rules, batch: int, sizes) -> float:
    shape = (batch, 1, cfg.vocab_size)
    spec = rules.physical(("act_batch", "act_seq", "act_vocab"), shape)
    return math.prod(shape) * cfg.dtype().itemsize / math.prod(
        sizes.get(a, 1) for a in spec_axes(spec))


def trace_costs(cell: BuiltCell) -> WeightedCosts:
    """The traced program's costs, weighted over the stacked groups (and
    the microbatches of a train step): ``op_costs.analyze_weighted``."""
    micro = cell.par.microbatches if cell.shape.kind == "train" else 1
    return analyze_weighted(cell.make, repeats=cell.cfg.repeats, microbatches=micro)


def _trace_key(cell: BuiltCell) -> str:
    """What the trace depends on: the arch, the shape, the parallel config
    (``moe_groups`` only where there is a MoE layer) and the rank split."""
    par = cell.par if cell.cfg.moe else dataclasses.replace(cell.par, moe_groups=1)
    return json.dumps([cell.meta["arch"], cell.meta["shape"], dataclasses.asdict(par),
                       cell.rank_split], sort_keys=True)


# --------------------------------------------------------------- run one --


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             par: ParallelConfig | None = None, verbose: bool = True,
             traces: dict | None = None) -> dict:
    """One cell's record. ``traces`` (a dict the caller keeps) reuses a
    trace of the same arch, shape and parallel config across meshes."""
    cell = build_cell(arch, shape_name, multi_pod=multi_pod, par=par)
    t0 = time.monotonic()
    key = _trace_key(cell)
    if traces is not None and key in traces:
        w, trace_s = traces[key]
        reused = True
    else:
        w = trace_costs(cell)
        trace_s = time.monotonic() - t0
        reused = False
        if traces is not None:
            traces[key] = (w, trace_s)
    n_chips = cell.meta["n_chips"]
    per = n_chips / cell.rank_split  # cards the traced program spreads over
    coll, rounds = cell.collectives
    terms = H.roofline_terms(w.matmul_flops / per, w.hbm_bytes / per, coll, n_chips=n_chips,
                             model_flops=cell.meta["model_flops"])
    mem = dict(cell.memory)
    mem["temp_bytes"] = w.peak_live_bytes / per
    mem["total_per_device"] = (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
                               - mem["alias_bytes"])
    record = {
        **cell.meta,
        "trace_s": round(trace_s, 1),
        "trace_reused": reused,
        "collective_bytes_by_op": {k: int(v) for k, v in coll.items()},
        "collective_rounds": {k: round(v, 1) for k, v in rounds.items() if v},
        "while_trip_counts": w.while_trip_counts[:12],
        "memory": mem,
        **terms,
    }
    if verbose:
        gb = mem["total_per_device"] / 1e9
        print(f"[{arch}.{shape_name}{'.2pod' if multi_pod else ''}] "
              f"trace={trace_s:.1f}s{' (reused)' if reused else ''} mem/dev={gb:.1f}GB "
              f"compute={terms['compute_s']:.4f}s memory={terms['memory_s']:.4f}s "
              f"collective={terms['collective_s']:.4f}s bottleneck={terms['bottleneck']} "
              f"roofline_frac={terms.get('roofline_fraction', 0):.3f}", flush=True)
    return record


# ------------------------------------------------------- GSP (the paper) --


def run_gsp_cell(*, multi_pod: bool = False, backend: str = "halo", side: int = 512,
                 signal_batch: int = 128, order: int = 20, verbose: bool = True) -> dict:
    """The paper's own workload on the production mesh: distributed
    Chebyshev application (Tikhonov denoising filter) over a ``side^2``
    vertex grid graph partitioned across all cards.

    Backends: 'allgather' (naive baseline), 'halo' (Algorithm 1,
    paper-faithful), 'ca<depth>' (beyond-paper communication-avoiding
    variant: depth-row halos, depth orders per exchange)."""
    n_chips = make_production_mesh(multi_pod=multi_pod).size
    record = _gsp_record(n_chips, backend=backend, side=side, signal_batch=signal_batch,
                         order=order)
    record["multi_pod"] = multi_pod
    if verbose:
        print(f"[sensor_gsp.{backend}{'.2pod' if multi_pod else ''}] "
              f"trace={record['trace_s']:.1f}s compute={record['compute_s']:.6f}s "
              f"memory={record['memory_s']:.6f}s collective={record['collective_s']:.6f}s "
              f"bottleneck={record['bottleneck']}", flush=True)
    return record


def _gsp_record(n_chips: int, *, backend: str, side: int, signal_batch: int,
                order: int) -> dict:
    """``run_gsp_cell``'s record on ``n_chips`` slabs, traced on a
    ``StackedMesh(n_chips, "meta")``: collective bytes are the mesh's byte
    counters over the ranks, FLOPs and bytes the trace's over the ranks."""
    from repro_torch.core import chebyshev, multipliers
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed import (grid_allgather_matvec, grid_cheb_apply_ca,
                                              grid_slab_matvec)

    if side % n_chips:
        raise ValueError(f"side {side} does not split into {n_chips} slabs")
    lmax = 8.0  # grid Laplacian bound
    coeffs = chebyshev.cheb_coefficients([multipliers.tikhonov(1.0, 1)], order, lmax)
    n = side * side
    mesh = StackedMesh(n_chips, META)
    f = torch.empty((n_chips, n // n_chips, signal_batch), dtype=torch.float32, device=META)
    matvecs = [0]

    if backend.startswith("ca"):
        # depth cannot exceed rows-per-slab (one-hop halos)
        depth = min(int(backend[2:] or 2), max(side // n_chips, 1))

        def fn(f_loc):
            return grid_cheb_apply_ca(f_loc, coeffs, lmax, side=side, mesh=mesh, depth=depth)
    else:
        mv_fn = grid_slab_matvec if backend == "halo" else grid_allgather_matvec

        def mv(v):
            matvecs[0] += 1
            return mv_fn(v, side=side, mesh=mesh)

        def fn(f_loc):
            return chebyshev.cheb_apply(mv, f_loc, coeffs, lmax)

    t0 = time.monotonic()
    w = analyze_step(fn, f)
    trace_s = time.monotonic() - t0
    kinds = {"shift": "collective-permute", "ring": "collective-permute",
             "all_gather": "all-gather", "all_to_all": "all-to-all"}
    coll = {k: 0.0 for k in COLLECTIVES}
    rounds = {k: 0.0 for k in COLLECTIVES}
    for kind, nbytes in mesh.bytes.items():
        coll[kinds[kind]] += nbytes / n_chips
        rounds[kinds[kind]] += mesh.calls[kind]
    # useful flops: 2 * nnz * F per matvec * M orders (+ combine AXPYs)
    nnz = 2 * (2 * side * (side - 1))  # directed edges
    model_flops = order * 2.0 * (nnz + n) * signal_batch
    terms = H.roofline_terms(w.matmul_flops / n_chips, w.hbm_bytes / n_chips, coll,
                             n_chips=n_chips, model_flops=model_flops)
    arg = n * signal_batch * 4 / n_chips
    return {
        "arch": "sensor_gsp", "shape": f"grid{side}x{side}_F{signal_batch}",
        "kind": "gsp", "backend": backend, "n_chips": n_chips, "order": order,
        "partition": "ideal", "analysis": "aten-trace-meta",
        "halo_words_per_matvec": 2 * side * (n_chips - 1),
        # words per matvec for all F columns, from the mesh's counter
        "measured_words_per_matvec": (mesh.elements["shift"] / matvecs[0]
                                      if backend == "halo" else None),
        "collective_rounds": {k: v for k, v in rounds.items() if v},
        "trace_s": round(trace_s, 1),
        "collective_bytes_by_op": {k: int(v) for k, v in coll.items()},
        "memory": {"argument_bytes": arg, "temp_bytes": w.peak_live_bytes / n_chips,
                   "total_per_device": arg + w.peak_live_bytes / n_chips},
        **terms,
    }


# ------------------------------------------------------------------ CLI --


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--gsp", action="store_true")
    ap.add_argument("--gsp-backend", default="halo")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    records = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    traces: dict = {}

    if args.gsp:
        for mp in meshes:
            for backend in ("halo", "allgather", "ca2"):
                records.append(run_gsp_cell(multi_pod=mp, backend=backend))
    elif args.all:
        for mp in meshes:
            for cell in CELLS:
                reason = cell_skip_reason(cell)
                if reason:
                    records.append({"arch": cell.arch, "shape": cell.shape.name,
                                    "multi_pod": mp, "skipped": reason})
                    print(f"[{cell.name}] SKIPPED: {reason}", flush=True)
                    continue
                try:
                    records.append(run_cell(cell.arch, cell.shape.name, multi_pod=mp,
                                            traces=traces))
                except Exception as e:  # record failures: they are bugs
                    traceback.print_exc()
                    records.append({"arch": cell.arch, "shape": cell.shape.name,
                                    "multi_pod": mp, "error": str(e)})
    else:
        records.append(run_cell(args.arch, args.shape, multi_pod=args.multi_pod))

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        existing = json.loads(out.read_text()) if out.exists() else []
        out.write_text(json.dumps(existing + records, indent=1))
        print(f"wrote {len(records)} records -> {args.out}")
    return records


if __name__ == "__main__":
    main()
