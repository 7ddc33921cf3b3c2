"""Serving launcher.

Mirrors ``repro/launch/serve.py`` in local mode: real batched generation
through the ``ServeEngine`` on ``--device`` (default ``cuda``, raising
without it), weights drawn from a seeded generator on that device.
``--dryrun`` hands the cell (``--arch``, ``--shape``, ``--multi-pod``) to
``repro_torch.launch.dryrun.main``, which traces it on ``meta``
tensors (no card) and prints its roofline record, as the reference hands
it to its AOT compile.

Examples:
  python -m repro_torch.launch.serve --arch gemma2_2b --smoke --tokens 16 --device cpu
  python -m repro_torch.launch.serve --arch gemma2_2b --batch 4 --prompt-len 4608 --tokens 64
  python -m repro_torch.launch.serve --arch gemma2_2b --dryrun
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.serve import ServeEngine

__all__ = ["PAR", "build", "serve", "main"]

PAR = ParallelConfig(attn_impl="naive", remat="none")


def build(arch: str, *, smoke: bool = False, device: str | torch.device | None = None,
          seed: int = 0) -> tuple[ModelConfig, dict]:
    """The config of ``arch`` (its smoke variant with ``smoke``) and params
    drawn on ``device`` from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    cfg = registry.get_smoke(arch) if smoke else registry.get(arch)
    params, _ = lm.init(torch.Generator(device=dev).manual_seed(seed), cfg, dev)
    return cfg, params


def serve(cfg: ModelConfig, params, *, batch: int = 4, prompt_len: int = 8, tokens: int = 16,
          temperature: float = 0.0, device: str | torch.device | None = None) -> dict:
    """One batched generation of ``tokens`` new ids for ``batch`` seeded
    prompts of ``prompt_len`` ids; the launcher's JSON record, with every
    generated id under ``"tokens"``."""
    dev = resolve_device(device)
    engine = ServeEngine(cfg=cfg, par=PAR, params=params, s_max=prompt_len + tokens + 8,
                         temperature=temperature, device=dev)
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    t0 = time.monotonic()
    out = engine.generate(prompts, max_new_tokens=tokens)
    dt = time.monotonic() - t0
    return {
        "arch": cfg.name,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": tokens,
        "wall_s": dt,
        "tokens_per_s": batch * tokens / dt,
        "sample": out[0][:8].tolist(),
        "tokens": out.tolist(),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.dryrun:
        from repro_torch.launch import dryrun

        dryrun.main(["--arch", args.arch, "--shape", args.shape]
                    + (["--multi-pod"] if args.multi_pod else []))
        raise SystemExit(0)

    cfg, params = build(args.arch, smoke=args.smoke, device=args.device)
    rec = serve(cfg, params, batch=args.batch, prompt_len=args.prompt_len, tokens=args.tokens,
                temperature=args.temperature, device=args.device)
    print(json.dumps({k: v for k, v in rec.items() if k != "tokens"}, indent=1))
    return rec


if __name__ == "__main__":
    main()
