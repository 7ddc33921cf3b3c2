"""Mamba-1 selective SSM layer (Gu & Dao 2023) for the Jamba hybrid.

Mirrors ``repro/models/mamba.py``. Training/prefill path: causal
depthwise conv + *chunked* selective scan with a sequential carry across
chunks. Inside a chunk the reference runs an associative scan of
``h_t = a_t h_{t-1} + b_t``; the port steps the same recurrence token by
token from the chunk's carried state, which is equal in exact arithmetic
(the rounding order differs, within the parity tests' 1e-5). Decode path:
O(1) recurrent step with carried (conv_state, ssm_state), written back
into the state tensors in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init
from repro_torch.models.sharding import ShardingRules, constrain

__all__ = ["init_mamba", "apply_mamba", "make_mamba_state"]


def init_mamba(rng: Init, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    d = cfg.d_model
    m = cfg.mamba
    di, ds, r = m.inner(d), m.d_state, m.rank(d)
    p = {
        "in_proj": rng.normal((d, 2 * di), d, dtype),
        "conv_w": rng.normal((m.d_conv, di), m.d_conv, dtype),
        "conv_b": rng.full((di,), 0.0, dtype),
        "x_proj": rng.normal((di, r + 2 * ds), di, dtype),
        "dt_proj": rng.normal((r, di), r, dtype),
        # softplus^-1 of ~[1e-3, 1e-1] inits
        "dt_bias": torch.log(torch.expm1(torch.exp(
            rng.uniform((di,), math.log(1e-3), math.log(1e-1))))).to(dtype),
        "A_log": rng.const(torch.log(
            torch.arange(1, ds + 1, dtype=torch.float32).repeat(di, 1))).to(dtype),
        "D": rng.full((di,), 1.0, dtype),
        "out_proj": rng.normal((di, d), di, dtype),
    }
    s = {
        "in_proj": ("d_model", "ffn"),
        "conv_w": ("conv_kernel", "ffn"),
        "conv_b": ("ffn",),
        "x_proj": ("ffn", None),
        "dt_proj": (None, "ffn"),
        "dt_bias": ("ffn",),
        "A_log": ("ffn", "state"),
        "D": ("ffn",),
        "out_proj": ("ffn", "d_model"),
    }
    return p, s


def _ssm_params(p, u, cfg):
    """u: (..., di) post-conv activations -> (dt, B, C) selective params."""
    m = cfg.mamba
    ds, r = m.d_state, m.rank(cfg.d_model)
    proj = u @ p["x_proj"]
    dt_r, b, c = torch.split(proj, [r, ds, ds], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])  # (..., di)
    return dt, b, c


def _chunk_scan(a, b, h0):
    """``h_t = a_t h_{t-1} + b_t`` within one chunk, from ``h0``.

    a, b: (B, c, di, ds); h0: (B, di, ds). Returns (h_all, h_last)."""
    hs = []
    h = h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def apply_mamba(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    rules: ShardingRules | None,
    chunk: int = 256,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, d). Decode: S == 1 with ``state`` carrying
    {conv: (B, d_conv-1, di), ssm: (B, di, ds)}, updated in place."""
    m = cfg.mamba
    b_sz, s_len, d = x.shape
    di = m.inner(d)
    xz = x @ p["in_proj"]
    xr, z = torch.chunk(xz, 2, dim=-1)  # (B,S,di) each
    xr = constrain(xr, rules, "act_batch", None, "act_ffn")

    a_mat = -torch.exp(p["A_log"].float())  # (di, ds)

    if state is None:
        # ---- causal depthwise conv (train/prefill) ----
        pad = F.pad(xr, (0, 0, m.d_conv - 1, 0))
        u = sum(pad[:, i: i + s_len] * p["conv_w"][i] for i in range(m.d_conv)) + p["conv_b"]
        u = F.silu(u)
        dt, bmat, cmat = _ssm_params(p, u, cfg)

        # ---- chunked selective scan ----
        n_chunks = -(-s_len // chunk)
        h = torch.zeros((b_sz, di, m.d_state), dtype=torch.float32, device=x.device)
        ys = []
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)  # the last chunk may be short
            dt_f = dt[:, sl].float()
            a_bar = torch.exp(dt_f[..., None] * a_mat)  # (B,c,di,ds)
            b_bar = (dt_f * u[:, sl].float())[..., None] * bmat[:, sl].float()[..., None, :]
            h_all, h = _chunk_scan(a_bar, b_bar, h)
            ys.append(torch.einsum("bcds,bcs->bcd", h_all, cmat[:, sl].float()).to(x.dtype))
        y = torch.cat(ys, dim=1)
        y = y + u * p["D"]
        new_state = None
    else:
        # ---- O(1) decode step ----
        conv_hist = torch.cat([state["conv"], xr], dim=1)
        u = torch.einsum("bkd,kd->bd", conv_hist, p["conv_w"]) + p["conv_b"]
        u = F.silu(u)[:, None]  # (B,1,di)
        dt, bmat, cmat = _ssm_params(p, u, cfg)
        dt_f = dt[:, 0].float()
        a_bar = torch.exp(dt_f[..., None] * a_mat)
        b_bar = (dt_f * u[:, 0].float())[..., None] * bmat[:, 0].float()[:, None, :]
        h = a_bar * state["ssm"] + b_bar
        y = torch.einsum("bds,bs->bd", h, cmat[:, 0].float())
        y = (y.to(x.dtype) + u[:, 0] * p["D"])[:, None]
        state["conv"].copy_(conv_hist[:, 1:])
        state["ssm"].copy_(h)
        new_state = state

    out = (y * F.silu(z)) @ p["out_proj"]
    return out, new_state


def make_mamba_state(cfg: ModelConfig, batch: int, dtype, device,
                     lead: tuple[int, ...] = ()) -> dict:
    m = cfg.mamba
    di = m.inner(cfg.d_model)
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, m.d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, di, m.d_state), dtype=torch.float32, device=device),
    }
