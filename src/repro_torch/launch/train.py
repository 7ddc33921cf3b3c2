"""Training launcher.

Mirrors ``repro/launch/train.py`` in local mode: real training on
``--device`` (default ``cuda``, raising without it), params drawn from a
generator seeded with 0 on that device, through ``make_train_step`` (or,
with ``--grad-sync gossip``, ``make_gossip_train_step`` on a
``StackedMesh`` of ``--n-parts`` ranks, which stands in for the
reference's mesh over ``len(jax.devices())``), ``jit_train_step``'s
donation, ``Trainer`` and ``run_with_restarts``. ``--dryrun`` hands the
cell (``--arch``, ``--shape``, ``--multi-pod``) to
``repro_torch.launch.dryrun.main``, which traces it on ``meta`` tensors (no
card), as the reference hands it to its AOT compile.

Examples:
  python -m repro_torch.launch.train --arch gemma2_2b --smoke --steps 5 --device cpu
  python -m repro_torch.launch.train --arch gemma2_2b --smoke --steps 20
  python -m repro_torch.launch.train --arch gemma2_2b --dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs import registry
from repro_torch.core.collectives import StackedMesh
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.donation import jit_train_step
from repro_torch.models import lm
from repro_torch.models.config import ParallelConfig
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import run_with_restarts
from repro_torch.runtime.fault import StragglerMonitor
from repro_torch.train import (HOST_REPLICA, Trainer, make_gossip_train_step, make_train_step,
                               replicate)

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--dryrun", action="store_true",
                    help="trace the production cell on meta tensors instead (launch.dryrun)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-sync", default="allreduce", choices=["allreduce", "gossip"])
    ap.add_argument("--gossip-order", type=int, default=None)
    ap.add_argument("--gossip-buckets", type=int, default=4,
                    help="flat gradient buckets for the gossip pipeline")
    ap.add_argument("--gossip-payload", default=None, choices=[None, "bfloat16", "float32"],
                    help="wire dtype of gossip exchanges (math stays f32)")
    ap.add_argument("--gossip-truncate", type=int, default=0,
                    help="drop the last r gossip rounds (bounded staleness)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="serial post-backward gossip (benchmark baseline)")
    ap.add_argument("--no-donate", action="store_true",
                    help="keep pre-step params/opt_state values (no in-place update)")
    ap.add_argument("--n-parts", type=int, default=8,
                    help="ranks of the StackedMesh that --grad-sync gossip runs on")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.dryrun:
        from repro_torch.launch import dryrun

        dryrun.main(["--arch", args.arch, "--shape", args.shape]
                    + (["--multi-pod"] if args.multi_pod else []))
        raise SystemExit(0)

    dev = resolve_device(args.device)
    gossip = args.grad_sync == "gossip"
    cfg = registry.get_smoke(args.arch) if args.smoke else registry.get(args.arch)
    par = ParallelConfig(attn_impl="naive", remat="none",
                         grad_sync=args.grad_sync,
                         gossip_order=args.gossip_order,
                         gossip_buckets=args.gossip_buckets,
                         gossip_overlap=not args.no_overlap,
                         gossip_payload_dtype=args.gossip_payload,
                         gossip_truncate=args.gossip_truncate,
                         fsdp=not gossip)
    optc = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, args.seq, args.batch, device=dev)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    if gossip:
        # Decentralized DP: replicate params, gossip the gradients over a
        # ring of --n-parts ranks stacked on the device.
        mesh = StackedMesh(args.n_parts, dev)
        step_fn = jit_train_step(make_gossip_train_step(cfg, par, optc, None, mesh),
                                 donate=not args.no_donate)
    else:
        step_fn = jit_train_step(make_train_step(cfg, par, optc), donate=not args.no_donate)

    def make_trainer(start_step: int) -> Trainer:
        params, _ = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
        opt = init_opt_state(params, optc)
        if start_step > 0:
            snap = restore(args.ckpt_dir, start_step, {"params": params, "opt": opt}, device=dev)
            params, opt = snap["params"], snap["opt"]
            print(f"resumed from step {start_step}")
        if gossip:
            params, opt = replicate(params, args.n_parts), replicate(opt, args.n_parts)
        return Trainer(train_step=step_fn, pipeline=pipe, ckpt=mgr,
                       params=params, opt_state=opt,
                       ckpt_every=args.ckpt_every,
                       straggler_monitor=StragglerMonitor(),
                       host_replica=HOST_REPLICA if gossip else None)

    result = run_with_restarts(make_trainer, args.steps,
                               latest_step_fn=lambda: latest_step(args.ckpt_dir))
    losses = result["losses"]
    record = {
        "arch": cfg.name, "device": str(dev), "steps": result["final_step"],
        "loss_first5": round(float(sum(losses[:5]) / max(len(losses[:5]), 1)), 4),
        "loss_last5": round(float(sum(losses[-5:]) / max(len(losses[-5:]), 1)), 4),
        "wall_s": round(result["wall_s"], 1),
        "restarts": result["restarts"],
    }
    print(json.dumps(record, indent=1))
    return {**record, "losses": losses}


if __name__ == "__main__":
    main()
