"""AdamW with optional reduced-precision moments.

Mirrors ``repro/optim/adamw.py``. ``adamw_update`` is functional: it
returns new tensors and leaves its arguments as they were.
``adamw_update_`` computes the same numbers (the same per-leaf function)
and writes them into the arguments, leaf by leaf: the donated train
step's optimiser (``launch.donation``). All math is in float32;
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
           "adamw_update", "adamw_update_", "cosine_schedule", "clip_by_global_norm"]


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


def _lead_shape(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` (shaped like the rank axes) with trailing unit axes up to
    ``ndim``, so it broadcasts over a leaf's own axes."""
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))


def _global_norm(leaves, lead: int) -> torch.Tensor:
    """2-norm of all ``leaves`` together, per index of the ``lead``
    leading (rank) axes: shape ``leaves[0].shape[:lead]``."""
    def sq(g):
        s = torch.square(g.to(torch.float32))
        return torch.sum(s) if lead == 0 else torch.sum(s.reshape(s.shape[:lead] + (-1,)), -1)

    return torch.sqrt(sum(sq(g) for g in leaves))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global 2-norm is at most ``max_norm``;
    returns ``(grads, norm)``."""
    gn = _global_norm(tree_leaves(grads), 0)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def _leaf_update(p, g, m, v, scale, lr, b1c, b2c, cfg: AdamWConfig):
    """One leaf's AdamW update: ``(p_new, m_new, v_new)``, new tensors in
    the dtypes of ``p``, ``m`` and ``v``. The f32 temporaries are updated
    in place where the expression allows (the same operations in the same
    order as ``b1 m + (1 - b1) g`` etc., so the same rounding), so a leaf
    keeps few of them alive at once."""
    sf = torch.float32
    nd = p.dim()
    gf = (g * _lead_shape(scale, nd)).to(g.dtype).to(sf)  # clipped, as clip_by_global_norm
    m_new = m.to(sf) * cfg.b1
    m_new += gf * (1 - cfg.b1)
    v_new = v.to(sf) * cfg.b2
    gf = torch.square(gf)
    gf *= 1 - cfg.b2
    v_new += gf
    del gf
    den = v_new / _lead_shape(b2c, nd)
    den.sqrt_()
    den += cfg.eps
    delta = m_new / _lead_shape(b1c, nd)
    delta /= den
    del den
    pf = p.to(sf)
    delta += pf * cfg.weight_decay
    delta *= _lead_shape(lr, nd)
    p_new = (pf - delta).to(p.dtype)
    mdt = getattr(torch, cfg.moment_dtype)
    return p_new, m_new.to(mdt), v_new.to(mdt)


def _hyper(grads, state: dict, cfg: AdamWConfig, step: torch.Tensor):
    """The per-step scalars (per rank on a stacked state, whose ``step``
    carries the rank axes): the clip scale, the norm, lr and the two bias
    corrections."""
    gn = _global_norm(tree_leaves(grads), state["step"].dim())
    lr = cosine_schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, step_f)
    b2c = 1.0 - torch.pow(cfg.b2, step_f)
    return _clip_scale(gn, cfg.clip_norm), gn, lr, b1c, b2c


def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step. Returns ``(params, state, metrics)``; the arguments
    are left as they were.

    A state whose ``step`` has leading (rank) axes, as ``train.replicate``
    makes it, updates every rank with its own clip norm, as the
    reference's ``shard_map`` ranks do; the metrics then carry those axes.
    """
    step = state["step"] + 1
    scale, gn, lr, b1c, b2c = _hyper(grads, state, cfg, step)
    flat_p, tdef = tree_flatten(params)
    out = [_leaf_update(p, g, m, v, scale, lr, b1c, b2c, cfg) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))]
    new_p = tdef.unflatten([o[0] for o in out])
    new_m = tdef.unflatten([o[1] for o in out])
    new_v = tdef.unflatten([o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"lr": lr, "grad_norm": gn}


@torch.no_grad()
def adamw_update_(params, grads, state: dict, cfg: AdamWConfig):
    """:func:`adamw_update` IN PLACE: the same numbers, written into the
    leaves of ``params`` and ``state`` leaf by leaf, so only one leaf's
    f32 temporaries are alive at a time (the donated train step's
    optimiser: at Gemma-2 2B an out-of-place step would hold a second
    params-and-moments copy, ~26 GB). Returns ``(params, state,
    metrics)`` with the same tensors it was given."""
    step = state["step"] + 1
    scale, gn, lr, b1c, b2c = _hyper(grads, state, cfg, step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        p_new, m_new, v_new = _leaf_update(p, g, m, v, scale, lr, b1c, b2c, cfg)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
        del p_new, m_new, v_new
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gn}
