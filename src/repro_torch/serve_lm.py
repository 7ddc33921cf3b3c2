"""Batched serving example: prefill + decode through the ServeEngine,
greedy and sampled generation, on a reduced Gemma-2 config.

Mirrors ``examples/serve_lm.py``. Checks, as the reference example does,
that greedy decoding is deterministic and that sampling gives one id per
requested token, and, beside them, that every sampled id is in the
vocabulary.

Run:  PYTHONPATH=src python -m repro_torch.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ParallelConfig
from repro_torch.serve import ServeEngine


def main(device: str | None = None) -> dict:
    dev = resolve_device(device)
    cfg = registry.get_smoke("gemma2_2b")
    params, _ = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    par = ParallelConfig(attn_impl="naive", remat="none")

    engine = ServeEngine(cfg=cfg, par=par, params=params, s_max=64, temperature=0.0, device=dev)

    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, size=(4, 8)).astype(np.int32)

    t0 = time.monotonic()
    out_greedy = engine.generate(prompts, max_new_tokens=16)
    t1 = time.monotonic()
    print(f"greedy batch=4 x 16 tokens in {t1 - t0:.3f}s (first call) on {dev}")
    print("greedy tokens:\n", out_greedy)

    again = engine.generate(prompts, max_new_tokens=16)
    if not (out_greedy == again).all():
        raise RuntimeError("greedy decode must be deterministic")

    sampled = ServeEngine(cfg=cfg, par=par, params=params, s_max=64, temperature=1.0, device=dev)
    out_s = sampled.generate(prompts, max_new_tokens=16, seed=7)
    print("sampled tokens:\n", out_s)
    if out_s.shape != (4, 16) or not ((out_s >= 0) & (out_s < cfg.vocab_size)).all():
        raise RuntimeError(f"sampled ids out of shape or vocabulary: {out_s.shape}")
    print("OK")
    return {"greedy": out_greedy, "sampled": out_s, "greedy_s": t1 - t0}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(ap.parse_args().device)
