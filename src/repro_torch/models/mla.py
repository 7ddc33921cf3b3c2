"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 Sec. 2.1) over a
latent cache.

The reference package has no latent attention; the equations are the
authors' ``modeling_deepseek.py``. For a token's normed hidden state ``h``:

* ``q = W_q h``: per head a ``qk_nope_head_dim`` part and a
  ``qk_rope_head_dim`` rotary part;
* ``[c_raw; k_pe] = W_kv_a h`` and ``c = RMSNorm(c_raw)``, the latent;
* per head ``[k_nope; v] = W_kv_b c``; the rotary key ``k_pe`` is one for
  all heads;
* RoPE (YaRN-scaled where the config says) rotates interleaved pairs
  ``(2i, 2i + 1)`` of ``q_pe`` and ``k_pe``;
* ``s = scale * (q_nope . k_nope + q_pe . k_pe)``, a causal softmax,
  ``o = sum p v`` per head and ``W_o [o_1 .. o_H]``.

A cache holds, per token and layer, the latent ``c`` and the rotated
``k_pe`` in one row of ``latent_dim`` values (``{"latent": (B, S_max,
r + d_rope), "len": 0-d int32}``), nothing per head. Two paths compute the
same attention:

* expanded (no cache: ``forward``, training, a cache-less prefill): keys
  and values are brought up per head and ``scaled_dot_product_attention``
  runs the causal softmax (values zero-padded to the query width, which
  its fused kernels need);
* absorbed (a cache: a decode step, a session's extension by several
  tokens): ``q_nope . k_nope = (W_UK^T q_nope) . c``, so the query is
  taken down to the latent, scores and the weighted sum run over cache
  rows, and ``W_UV`` is applied to ``sum p c`` afterwards. Keys go in
  chunks with a running softmax in f32, so that a long extension against
  a long cache keeps its scores small.

The new tokens' rows are written into the cache IN PLACE at ``len``, which
advances, as ``layers.apply_attention`` does for per-head caches.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.device import cached_upload
from repro_torch.models.config import MLAConfig, ModelConfig
from repro_torch.models.layers import Init, apply_norm, init_linear, linear

__all__ = ["yarn_inv_freq", "softmax_scale", "rope_interleaved", "init_mla", "apply_mla",
           "latent_rows", "absorbed_attention", "make_latent_cache", "ABSORB_SCORES"]

NEG_INF = float("-inf")
# Largest number of f32 scores one chunk of the absorbed path holds
# (batch x queries x heads x keys): 512 MB.
ABSORB_SCORES = 1 << 27


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(mla: MLAConfig, theta: float, device=None) -> torch.Tensor:
    """The rotary inverse frequencies (``qk_rope_head_dim // 2``, f32),
    computed in float64: plain RoPE's ``theta ** (-2i / d)``, or under
    YaRN the ramp between them and their ``factor``-fold interpolation.
    Every layer of every step reads it, so it goes up once per device
    (``device.cached_upload``; a recorded graph keeps it with
    ``pinned_uploads``)."""
    return cached_upload(_inv_freq_f64(mla, theta), device or "cpu", torch.float32)


@functools.lru_cache(maxsize=16)
def _inv_freq_f64(mla: MLAConfig, theta: float) -> np.ndarray:
    d = mla.qk_rope_head_dim
    i = torch.arange(d // 2, dtype=torch.float64)
    base = theta ** (-2.0 * i / d)
    y = mla.rope_scaling
    if y is None:
        return base.numpy()

    def corr(rotations: float) -> float:
        return d * math.log(y.original_max_position / (rotations * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(corr(y.beta_fast)), 0)
    high = min(math.ceil(corr(y.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    return (base / y.factor * ramp + base * (1.0 - ramp)).numpy()


def softmax_scale(mla: MLAConfig) -> float:
    """``qk_head_dim ** -0.5``, times ``m ** 2`` under YaRN, where ``m =
    0.1 * mscale_all_dim * ln(factor) + 1`` (DeepSeek-V2's attention
    scale; the rotary cos and sin are scaled by ``m(mscale) /
    m(mscale_all_dim)``, which its config makes 1)."""
    scale = mla.qk_head_dim ** -0.5
    y = mla.rope_scaling
    if y is not None and y.mscale_all_dim:
        scale *= _yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _cos_sin_scale(mla: MLAConfig) -> float:
    y = mla.rope_scaling
    if y is None:
        return 1.0
    return _yarn_mscale(y.factor, y.mscale) / _yarn_mscale(y.factor, y.mscale_all_dim)


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                     mscale: float = 1.0) -> torch.Tensor:
    """Rotate the interleaved pairs ``(2i, 2i + 1)`` of the last axis by
    ``positions * inv_freq[i]``. x: (B, S, D) or (B, S, H, D); positions
    (S,). Computed in f32, returned in x's dtype."""
    ang = positions.float()[:, None] * inv_freq  # (S, D/2)
    if x.dim() == 4:
        ang = ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)


def init_mla(rng: Init, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    mla, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    p, s = {}, {}
    p["q"], s["q"] = init_linear(rng, d, h * mla.qk_head_dim, dtype, ("d_model", "heads"))
    p["kv_a"], s["kv_a"] = init_linear(rng, d, mla.latent_dim, dtype, ("d_model", None))
    p["kv_norm"], s["kv_norm"] = {"w": rng.full((mla.kv_lora_rank,), 1.0, dtype)}, {"w": (None,)}
    p["kv_b"], s["kv_b"] = init_linear(
        rng, mla.kv_lora_rank, h * (mla.qk_nope_head_dim + mla.v_head_dim), dtype,
        (None, "heads"))
    p["o"], s["o"] = init_linear(rng, h * mla.v_head_dim, d, dtype, ("heads", "d_model"))
    return p, s


def make_latent_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, device,
                      lead: tuple[int, ...] = ()) -> dict:
    """An empty latent cache for one layer (``lead`` stacks layers)."""
    lead = tuple(lead)
    return {"latent": torch.zeros(lead + (batch, s_max, cfg.mla.latent_dim), dtype=dtype,
                                  device=device),
            "len": torch.zeros(lead, dtype=torch.int32, device=device)}


def latent_rows(p: dict, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The cache rows of normed hidden states h (B, S, d): ``[RMSNorm(c);
    rope(k_pe)]``, (B, S, latent_dim)."""
    mla = cfg.mla
    c, k_pe = linear(p["kv_a"], h).split([mla.kv_lora_rank, mla.qk_rope_head_dim], dim=-1)
    c = apply_norm(p["kv_norm"], c, cfg.norm)
    inv_freq = yarn_inv_freq(mla, cfg.rope_theta, h.device)
    k_pe = rope_interleaved(k_pe, positions, inv_freq, _cos_sin_scale(mla))
    return torch.cat([c, k_pe], dim=-1)


def _queries(p: dict, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    mla = cfg.mla
    b, s, _ = h.shape
    q = linear(p["q"], h).view(b, s, cfg.n_heads, mla.qk_head_dim)
    q_nope, q_pe = q.split([mla.qk_nope_head_dim, mla.qk_rope_head_dim], dim=-1)
    inv_freq = yarn_inv_freq(mla, cfg.rope_theta, h.device)
    return q_nope, rope_interleaved(q_pe, positions, inv_freq, _cos_sin_scale(mla))


def _expanded(p: dict, q_nope, q_pe, rows, cfg: ModelConfig):
    """Causal attention of S queries over their own S rows, keys and values
    brought up per head. Returns (B, S, H, v_head_dim)."""
    mla = cfg.mla
    b, s, h, _ = q_nope.shape
    c, k_pe = rows.split([mla.kv_lora_rank, mla.qk_rope_head_dim], dim=-1)
    kv = linear(p["kv_b"], c).view(b, s, h, mla.qk_nope_head_dim + mla.v_head_dim)
    k_nope, v = kv.split([mla.qk_nope_head_dim, mla.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, h, mla.qk_rope_head_dim)],
                  dim=-1).transpose(1, 2)
    v = F.pad(v, (0, mla.qk_head_dim - mla.v_head_dim)).transpose(1, 2)
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=softmax_scale(mla))
    return out[..., :mla.v_head_dim].transpose(1, 2)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, in a float32 result: on the card the product's own
    f32 accumulator (``out_dtype``, no rounding to the operands' bfloat16);
    on the CPU the operands upcast, which gives the same products."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def absorbed_attention(q_nope, q_pe, latent, q_rows, w_kv_b, mla: MLAConfig,
                       chunk: int | None = None):
    """Attention of queries (B, S, H, .) at cache rows ``q_rows`` (S,) over
    the cache ``latent`` (B, T, latent_dim): row j is a key of the query at
    row i where j <= i. ``W_UK`` goes into the query and ``W_UV`` after the
    weighted sum of latents; keys in chunks of ``chunk`` (default: as many
    as ``ABSORB_SCORES`` allows) under a running f32 softmax, or one plain
    softmax where one chunk holds them all. Returns (B, S, H, v_head_dim)."""
    b, s, h, _ = q_nope.shape
    r, t = mla.kv_lora_rank, latent.shape[1]
    w = w_kv_b.view(r, h, mla.qk_nope_head_dim + mla.v_head_dim)
    w_uk, w_uv = w[..., :mla.qk_nope_head_dim], w[..., mla.qk_nope_head_dim:]
    # The scale goes into the query (in f32, before its one rounding).
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    q_all = (torch.cat([q_lat, q_pe], dim=-1).float() * softmax_scale(mla)).to(latent.dtype)
    q_all = q_all.reshape(b, s * h, mla.latent_dim)
    chunk = chunk or max(ABSORB_SCORES // (b * s * h), 1)
    q_rows = q_rows.long()[:, None, None].expand(s, h, 1).reshape(s * h, 1)
    hidden = torch.arange(t, device=latent.device)[None, :] > q_rows  # (S*H, T)
    if chunk >= t:  # one chunk: a plain softmax
        scores = _bmm_f32(q_all, latent.transpose(1, 2)).masked_fill_(hidden, NEG_INF)
        o_lat = torch.bmm(torch.softmax(scores, dim=-1).to(latent.dtype), latent[..., :r])
    else:
        m = torch.full((b, s * h, 1), NEG_INF, dtype=torch.float32, device=latent.device)
        den = torch.zeros((b, s * h, 1), dtype=torch.float32, device=latent.device)
        acc = torch.zeros((b, s * h, r), dtype=torch.float32, device=latent.device)
        for c0 in range(0, t, chunk):
            kc = latent[:, c0:c0 + chunk]
            scores = _bmm_f32(q_all, kc.transpose(1, 2))
            scores.masked_fill_(hidden[:, c0:c0 + chunk], NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
            m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
            probs = scores.sub_(m_safe).exp_()
            corr = torch.exp(m - m_safe)
            den = den * corr + probs.sum(-1, keepdim=True)
            acc = acc * corr + _bmm_f32(probs.to(latent.dtype), kc[..., :r])
            m = m_new
        o_lat = acc / den
    return torch.einsum("bshr,rhv->bshv", o_lat.to(q_nope.dtype).view(b, s, h, r), w_uv)


def apply_mla(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
              cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """Latent attention of normed hidden states x (B, S, d) at ``positions``
    (S,). Without ``cache`` the expanded path over x's own tokens; with
    one, the tokens' rows go into it at ``cache["len"]`` (in place) and the
    absorbed path attends over the cache. Returns (output, cache)."""
    mla = cfg.mla
    b, s, _ = x.shape
    q_nope, q_pe = _queries(p, x, cfg, positions)
    rows = latent_rows(p, x, cfg, positions)
    if cache is None:
        with telemetry.span("mla.attend", device=True, mode="expanded", rows=b, keys=s):
            out = _expanded(p, q_nope, q_pe, rows, cfg)
    else:
        q_rows = cache["len"].long() + torch.arange(s, device=x.device)
        cache["latent"].index_copy_(1, q_rows, rows.to(cache["latent"].dtype))
        cache["len"].add_(s)
        latent = cache["latent"]
        with telemetry.span("mla.attend", device=True, mode="absorbed", rows=b,
                            keys=latent.shape[1]):
            out = absorbed_attention(q_nope, q_pe, latent, q_rows, p["kv_b"]["w"], mla)
    return linear(p["o"], out.reshape(b, s, cfg.n_heads * mla.v_head_dim)), cache
