"""AdamW with optional reduced-precision moments.

Mirrors ``repro/optim/adamw.py``, functionally: every call returns new
tensors and leaves its arguments as they were. All math is in float32;
the moments are stored in ``moment_dtype`` (``"float32"`` or
``"bfloat16"``, which halves optimiser memory); ``step`` is an int32 0-d
tensor on the parameters' device. Trees are flattened as jax does
(``repro_torch.tree``), so the state's leaves line up with the
reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "opt_state_specs",
           "adamw_update", "cosine_schedule", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine decay to 0 at
    ``total_steps``; a float32 0-d tensor (on ``step``'s device when it
    is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = frac.clamp(0.0, 1.0)
    cos = 0.5 * cfg.peak_lr * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``moment_dtype`` beside each parameter, and step 0."""
    dt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_specs(param_specs):
    """Moments share the parameter logical specs; step is replicated."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global 2-norm is at most ``max_norm``;
    returns ``(grads, norm)``."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step. Returns ``(params, state, metrics)``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    sf = torch.float32
    step_f = step.to(sf)
    b1c = 1.0 - torch.pow(cfg.b1, step_f)
    b2c = 1.0 - torch.pow(cfg.b2, step_f)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        gf = g.to(sf)
        m_new = cfg.b1 * m.to(sf) + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.to(sf) + (1 - cfg.b2) * torch.square(gf)
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p_new = p.to(sf) - lr * (delta + cfg.weight_decay * p.to(sf))
        return p_new.to(p.dtype), m_new.to(mdt), v_new.to(mdt)

    flat_p, tdef = tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))]
    new_p = tdef.unflatten([o[0] for o in out])
    new_m = tdef.unflatten([o[1] for o in out])
    new_v = tdef.unflatten([o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"lr": lr, "grad_norm": gnorm}
