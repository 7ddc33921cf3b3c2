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

A ``DroplessMoEConfig`` (DeepSeek-V2; no counterpart in the reference)
keeps the chosen scores as they are unless ``norm_topk`` and dispatches
without a capacity: the (token, slot) pairs sorted by expert, every expert
computes exactly its tokens (``_dropless_experts``), and the gate-weighted
sum over a token's slots runs in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, apply_dense_ffn, init_dense_ffn
from repro_torch.models.sharding import ShardingRules, constrain

__all__ = ["init_moe", "apply_moe", "top_k_lower_index", "group_capacity", "STATIC_DEPTH_TOKENS"]

# Up to this many tokens (a decode step's batch) a dropless dispatch runs the
# experts as one batched product over a buffer as deep as the token count,
# which needs no host read; past it, each expert on exactly its tokens.
STATIC_DEPTH_TOKENS = 64


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
    xf = x.reshape(t, d)

    with telemetry.span("moe.route", tokens=t):
        logits = xf.float() @ p["router"]  # (T, E)
        probs = torch.softmax(logits, dim=-1)
        gate, idx = top_k_lower_index(probs, k)  # (T, k)
        if moe.norm_topk:
            gate = gate / gate.sum(-1, keepdim=True)

        # Switch-style load-balance auxiliary loss.
        density = F.one_hot(idx[:, 0], e).float().mean(0)
        router_mean = probs.mean(0)
        aux = e * torch.sum(density * router_mean)
    if telemetry.on():
        telemetry.count("moe.expert_tokens", _expert_counts(idx.reshape(-1), e))

    with telemetry.span("moe.experts", tokens=t):
        if moe.dropless:
            out = _dropless_experts(p, xf, gate, idx, e)
        else:
            out = _capacity_experts(p, xf, gate, idx, rules, g, cap)
        if moe.n_shared:
            out = out + apply_dense_ffn(p["shared"], xf, cfg.act)
    return out.reshape(b, s, d), aux


def _capacity_experts(p, xf, gate, idx, rules, g: int, cap: int):
    """The reference's dispatch: ``g`` groups, each into its own (E, cap)
    buffer; pairs past an expert's capacity are dropped."""
    t, d = xf.shape
    e, k = p["wi_gate"].shape[0], idx.shape[-1]
    tg = t // g
    xg = constrain(xf.reshape(g, tg, d), rules, "act_moe_group", None, None)
    gate_g = gate.reshape(g, tg, k)
    idx_g = idx.reshape(g, tg, k)

    groups = [_group_dispatch(xg[i], gate_g[i], idx_g[i], e, cap) for i in range(g)]
    if telemetry.on():
        telemetry.count("moe.dropped_tokens", sum((gr[1] == e * cap).sum() for gr in groups))
    buf = torch.stack([gr[0] for gr in groups])  # (g, e, cap, d)
    buf = constrain(buf, rules, "act_moe_group", "act_experts", None, None)

    h = torch.einsum("gecd,edf->gecf", buf, p["wi_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, p["wi_up"])
    y = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["wo"])
    y = constrain(y, rules, "act_moe_group", "act_experts", None, None)

    out = torch.stack([_group_combine(y[i], dest, token_of, gates, tg)
                       for i, (_, dest, token_of, gates) in enumerate(groups)])
    return constrain(out, rules, "act_moe_group", None, None).reshape(t, d)


def _expert_counts(flat: torch.Tensor, e: int) -> torch.Tensor:
    """(E,) pairs per expert, without a host read (``torch.bincount`` on a
    CUDA tensor reads the largest index back to size its output)."""
    return torch.zeros(e, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _dropless_experts(p, xf, gate, idx, e: int):
    """Every (token, slot) pair computed by its expert, pairs sorted by
    expert (stable). Up to ``STATIC_DEPTH_TOKENS`` tokens the sorted pairs
    fill an (E, T) buffer (no expert holds more than T pairs) for one
    batched product per matrix, its rows past an expert's count zeros
    whose outputs are never read; past it, each expert's SwiGLU runs on
    exactly its slice of the sorted pairs (one host read of the counts).
    Returns (T, d): each token's gate-weighted sum in f32.

    While telemetry records, ``moe.dropped_tokens`` counts the pairs whose
    expert output the dispatch did not compute: a slot past its expert's
    T rows or shared with another pair, or a sorted pair outside every
    expert's slice."""
    t, d = xf.shape
    k = idx.shape[-1]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = _expert_counts(flat, e)
    xs = xf[order // k]
    record = telemetry.on()
    if t <= STATIC_DEPTH_TOKENS:
        sorted_e = flat[order]
        starts = torch.cumsum(counts, 0) - counts
        depth = torch.arange(t * k, device=xf.device) - starts[sorted_e]
        slot = sorted_e * t + depth
        buf = torch.zeros((e * t, d), dtype=xf.dtype, device=xf.device)
        buf[slot] = xs
        buf = buf.view(e, t, d)
        h = torch.bmm(buf, p["wi_gate"])
        u = torch.bmm(buf, p["wi_up"])
        ys = torch.bmm(F.silu(h) * u, p["wo"]).view(e * t, d)[slot]
        if record:
            served = (depth < t) & (_expert_counts(slot, e * t)[slot] == 1)
    else:
        ys = torch.empty_like(xs)
        served = torch.zeros(t * k, dtype=torch.bool, device=xf.device) if record else None
        start = 0
        for ex, n in enumerate(counts.tolist()):
            if n:
                xe = xs[start:start + n]
                h = F.silu(xe @ p["wi_gate"][ex]) * (xe @ p["wi_up"][ex])
                torch.mm(h, p["wo"][ex], out=ys[start:start + n])
                if record:
                    served[start:start + n] = True
            start += n
    if record:
        telemetry.count("moe.dropped_tokens", t * k - served.sum())
    y = torch.empty_like(ys)
    y[order] = ys
    return torch.einsum("tkd,tk->td", y.view(t, k, d).float(), gate).to(xf.dtype)
