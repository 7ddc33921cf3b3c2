"""End-to-end training driver: train a small LM with the full substrate
(deterministic data pipeline, AdamW, async checkpointing, restart on
failure) and report the loss curve.

Mirrors ``examples/train_lm.py``: the same presets (``tiny``: 2 layers,
3 steps; ``small``: ~10 M params, 120 steps; ``100m``: ~100 M params, 300
steps) and the same self-checks (over >= 50 steps the loss falls by 0.3;
a shorter run must give finite losses), on ``--device`` (default
``cuda``). ``--grad-sync gossip`` trains on a ``StackedMesh`` of
``--n-parts`` ranks, standing in for the reference's mesh over all local
devices.

Run:  PYTHONPATH=src python -m repro_torch.train_lm [--preset 100m] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.core.collectives import StackedMesh
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.donation import jit_train_step
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import run_with_restarts
from repro_torch.train import (HOST_REPLICA, Trainer, make_gossip_train_step, make_train_step,
                               replicate)
from repro_torch.tree import tree_leaves

__all__ = ["PRESETS", "preset_config", "main"]

PRESETS = {
    # seconds-scale smoke
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 d_ff=256, vocab_size=512, steps=3, batch=8, seq=32),
    # ~10M params
    "small": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                  d_ff=1024, vocab_size=2048, steps=120, batch=8, seq=128),
    # ~100M params: the deliverable-scale driver
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=3072, vocab_size=32768, steps=300, batch=16, seq=256),
}


def preset_config(preset: str) -> ModelConfig:
    """The dense SwiGLU decoder of ``preset`` (the reference example's)."""
    p = PRESETS[preset]
    return ModelConfig(
        name=f"lm-{preset}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], pattern=("attn",),
        ffn_pattern=("dense",), act="swiglu")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--grad-sync", default="allreduce", choices=["allreduce", "gossip"],
                    help="gossip = decentralized DP over --n-parts stacked ranks"
                         " (bucketed Chebyshev-gossip gradient sync)")
    ap.add_argument("--n-parts", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    p = PRESETS[args.preset]
    steps = args.steps or p["steps"]

    cfg = preset_config(args.preset)
    n_params = sum(x.numel() for x in tree_leaves(lm.abstract_init(cfg)[0]))
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  steps={steps}  device={dev}")

    optc = AdamWConfig(peak_lr=3e-3, warmup_steps=max(steps // 10, 1), total_steps=steps)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, p["seq"], p["batch"], device=dev)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
    mgr = CheckpointManager(ckpt_dir, keep=2)
    gossip = args.grad_sync == "gossip"
    if gossip:
        par = ParallelConfig(attn_impl="naive", remat="none", grad_sync="gossip",
                             gossip_buckets=4, gossip_overlap=True, fsdp=False)
        mesh = StackedMesh(args.n_parts, dev)
        step_fn = jit_train_step(make_gossip_train_step(cfg, par, optc, None, mesh))
        print(f"grad-sync: bucketed Chebyshev gossip over {args.n_parts} ranks")
    else:
        par = ParallelConfig(attn_impl="naive", remat="none")
        step_fn = jit_train_step(make_train_step(cfg, par, optc))

    def make_trainer(start_step):
        params, _ = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
        opt = init_opt_state(params, optc)
        if start_step:
            snap = restore(ckpt_dir, start_step, {"params": params, "opt": opt}, device=dev)
            params, opt = snap["params"], snap["opt"]
        if gossip:
            params, opt = replicate(params, args.n_parts), replicate(opt, args.n_parts)
        return Trainer(train_step=step_fn, pipeline=pipe, ckpt=mgr, params=params,
                       opt_state=opt, ckpt_every=50,
                       host_replica=HOST_REPLICA if gossip else None)

    result = run_with_restarts(make_trainer, steps, latest_step_fn=lambda: latest_step(ckpt_dir))
    losses = result["losses"]
    first = sum(losses[:10]) / len(losses[:10])
    last = sum(losses[-10:]) / len(losses[-10:])
    record = {
        "steps": result["final_step"],
        "loss_first10": round(first, 4),
        "loss_last10": round(last, 4),
        "wall_s": round(result["wall_s"], 1),
        "tokens_per_s": round(result["final_step"] * p["batch"] * p["seq"] / result["wall_s"], 1),
        "ckpt_dir": ckpt_dir,
    }
    print(json.dumps(record, indent=1))
    if steps >= 50:
        if not last < first - 0.3:
            raise RuntimeError(f"loss should decrease measurably: {first:.4f} -> {last:.4f}")
    elif not all(l == l and l < 1e4 for l in losses):
        # smoke runs: the loop completed and produced finite losses
        raise RuntimeError(f"non-finite or exploding losses: {losses}")
    print("OK")
    return {**record, "losses": losses}


if __name__ == "__main__":
    main()
