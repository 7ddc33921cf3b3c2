"""Mixture-of-experts FFN: shared + fine-grained routed experts
(DeepSeekMoE / GShard style) with *grouped* sort-based capacity dispatch.

Mirrors ``repro/models/moe.py``. Tokens are partitioned into
``n_groups`` dispatch groups and each group routes into its own
``(E, C_g)`` capacity buffer. Dispatch is scatter/gather-based (no one-hot
dispatch einsum), so the work is the active experts' only.

Order rules kept from the reference, each of which decides which tokens
a full expert drops:

* top-k takes the lower expert index on tied probabilities, as
  ``jax.lax.top_k`` does (a stable descending sort, not ``torch.topk``,
  whose tie order is unspecified);
* the expert-major order of the (token, slot) pairs is a STABLE argsort,
  so within an expert the earlier token keeps its capacity slot;
* pairs past an expert's capacity go to the sentinel row ``E * cap``,
  which is dropped, and the combine is an ``index_add_`` over tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, apply_dense_ffn, init_dense_ffn
from repro_torch.models.sharding import ShardingRules, constrain

__all__ = ["init_moe", "apply_moe", "top_k_lower_index", "group_capacity"]


def init_moe(rng: Init, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    moe = cfg.moe
    d, de, e = cfg.d_model, moe.d_expert, moe.n_experts
    p = {
        "router": rng.normal((d, e), d, torch.float32),
        "wi_gate": rng.normal((e, d, de), d, dtype),
        "wi_up": rng.normal((e, d, de), d, dtype),
        "wo": rng.normal((e, de, d), de, dtype),
    }
    s = {
        "router": ("d_model", None),
        "wi_gate": ("experts", "d_model", "expert_ffn"),
        "wi_up": ("experts", "d_model", "expert_ffn"),
        "wo": ("experts", "expert_ffn", "d_model"),
    }
    if moe.n_shared:
        p["shared"], s["shared"] = init_dense_ffn(rng, cfg, dtype, d_ff=moe.n_shared * de)
    return p, s


def top_k_lower_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis, largest first, and their
    indices; equal entries in index order (``jax.lax.top_k``'s rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def group_capacity(tokens: int, n_groups: int, k: int, e: int, cf: float) -> tuple[int, int]:
    """``(groups, capacity)``: ``n_groups`` dispatch groups when they split
    the tokens evenly (else one), and each group's per-expert capacity,
    padded to a multiple of 8."""
    g = n_groups if tokens % n_groups == 0 else 1
    cap = int(math.ceil(tokens // g * k / e * cf))
    return g, max(8, -(-cap // 8) * 8)


def _group_dispatch(xg, gate, idx, e: int, cap: int):
    """One group's dispatch. xg: (Tg, d); gate/idx: (Tg, k).

    Returns (buf (e, cap, d), dest (Tg*k,), token_of (Tg*k,), gates)."""
    tg, d = xg.shape
    k = idx.shape[-1]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_of = order // k
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=xg.device), side="left")
    pos = torch.arange(tg * k, device=xg.device) - starts[sorted_e]
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=xg.dtype, device=xg.device)
    buf[dest] = xg[token_of]  # only the sentinel row sees repeated writes
    gates = torch.where(keep, gate.reshape(-1)[order], 0.0)
    return buf[: e * cap].reshape(e, cap, d), dest, token_of, gates


def _group_combine(y, dest, token_of, gates, tg: int):
    """Gather expert outputs back + gate-weighted scatter-add to tokens."""
    e_cap, d = y.shape[0] * y.shape[1], y.shape[2]
    y_flat = torch.cat([y.reshape(e_cap, d), torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    contrib = y_flat[dest] * gates.to(y.dtype)[:, None]
    return torch.zeros((tg, d), dtype=y.dtype, device=y.device).index_add_(0, token_of, contrib)


def apply_moe(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    rules: ShardingRules | None,
    n_groups: int = 1,
    capacity_factor: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed-expert FFN. x: (B, S, d). Returns (out, aux_loss)."""
    moe = cfg.moe
    cf = capacity_factor or moe.capacity_factor
    b, s, d = x.shape
    t = b * s
    e, k = moe.n_experts, moe.top_k
    g, cap = group_capacity(t, n_groups, k, e, cf)
    tg = t // g
    xf = x.reshape(t, d)

    logits = xf.float() @ p["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k_lower_index(probs, k)  # (T, k)
    gate = gate / gate.sum(-1, keepdim=True)

    # Switch-style load-balance auxiliary loss.
    density = F.one_hot(idx[:, 0], e).float().mean(0)
    router_mean = probs.mean(0)
    aux = e * torch.sum(density * router_mean)

    xg = constrain(xf.reshape(g, tg, d), rules, "act_moe_group", None, None)
    gate_g = gate.reshape(g, tg, k)
    idx_g = idx.reshape(g, tg, k)

    groups = [_group_dispatch(xg[i], gate_g[i], idx_g[i], e, cap) for i in range(g)]
    buf = torch.stack([gr[0] for gr in groups])  # (g, e, cap, d)
    buf = constrain(buf, rules, "act_moe_group", "act_experts", None, None)

    h = torch.einsum("gecd,edf->gecf", buf, p["wi_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, p["wi_up"])
    y = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["wo"])
    y = constrain(y, rules, "act_moe_group", "act_experts", None, None)

    out = torch.stack([_group_combine(y[i], dest, token_of, gates, tg)
                       for i, (_, dest, token_of, gates) in enumerate(groups)])
    out = constrain(out, rules, "act_moe_group", None, None).reshape(t, d)

    if moe.n_shared:
        out = out + apply_dense_ffn(p["shared"], xf, cfg.act)
    return out.reshape(b, s, d), aux
