"""Core neural layers: norms, rotary embeddings, attention (naive/chunked/
decode), dense FFN variants, embeddings.

Mirrors ``repro/models/layers.py``. Pure-functional style: ``init_*``
returns ``(params, logical_specs)`` twin trees; ``apply`` functions take
the params tree. Softmax/norm statistics always accumulate in f32
regardless of activation dtype.

Where torch's defaults differ from jax's, the port follows jax:

* ``jnp.var`` is the population variance: ``var(correction=0)``;
* ``jax.nn.gelu`` defaults to the tanh approximation:
  ``gelu(approximate="tanh")`` (torch's default is the exact erf form);
* the attention scores contract in the input dtype and are upcast after
  (``_gqa_scores``): in bf16 the matmul accumulates in f32 and rounds its
  output to bf16, as the reference's einsum does, before the f32 softmax.

Decode writes one token's k/v into the cache IN PLACE (``index_copy_`` at
``cache["len"]``, a 0-d int32 device tensor), so a step moves one token's
k/v and not a copy of the whole cache, and reads no index on the host.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardingRules, constrain

__all__ = [
    "Init", "init_norm", "apply_norm", "init_embedding", "init_attention",
    "apply_attention", "init_dense_ffn", "apply_dense_ffn", "rope",
    "softcap", "init_linear", "linear", "make_cache", "NEG_INF",
]

NEG_INF = -1e30


class Init:
    """Where parameters are drawn: a ``torch.Generator`` (its device is
    where they live), or the ``meta`` device (shapes only, no memory).

    ``lead`` is prepended to every shape: a pattern group's blocks are
    drawn at once with ``lead=(repeats,)``, the stacked layout the
    reference's vmapped init gives. Draws come from one generator stream,
    so they are deterministic per seed but are not jax's stream."""

    def __init__(self, gen: torch.Generator | None, device: torch.device,
                 lead: tuple[int, ...] = ()):
        if device.type != "meta" and (gen is None or gen.device.type != device.type):
            raise ValueError(f"a {device} init needs a generator on {device.type}")
        self.gen, self.device, self.lead = gen, device, tuple(lead)

    def stacked(self, n: int) -> "Init":
        return Init(self.gen, self.device, self.lead + (n,))

    def _shape(self, shape) -> tuple[int, ...]:
        return self.lead + tuple(shape)

    def normal(self, shape, fan_in: int, dtype: torch.dtype) -> torch.Tensor:
        """N(0, 1) / sqrt(fan_in), drawn in f32 and cast to ``dtype``."""
        if self.device.type == "meta":
            return torch.empty(self._shape(shape), dtype=dtype, device="meta")
        x = torch.randn(self._shape(shape), generator=self.gen, device=self.device)
        return (x / math.sqrt(max(fan_in, 1))).to(dtype)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        """Uniform on [lo, hi) in f32."""
        if self.device.type == "meta":
            return torch.empty(self._shape(shape), device="meta")
        u = torch.rand(self._shape(shape), generator=self.gen, device=self.device)
        return lo + (hi - lo) * u

    def full(self, shape, value: float, dtype: torch.dtype) -> torch.Tensor:
        return torch.full(self._shape(shape), value, dtype=dtype, device=self.device)

    def const(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (built on the host) broadcast over ``lead`` on the device."""
        return t.to(self.device).expand(self._shape(t.shape)).contiguous()


def init_linear(rng: Init, d_in, d_out, dtype, spec, bias=False, bias_spec=None):
    p = {"w": rng.normal((d_in, d_out), d_in, dtype)}
    s = {"w": spec}
    if bias:
        p["b"] = rng.full((d_out,), 0.0, dtype)
        s["b"] = bias_spec or (spec[-1],)
    return p, s


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------- norms --


def init_norm(rng: Init, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return ({"w": rng.full((d,), 1.0, dtype), "b": rng.full((d,), 0.0, dtype)},
                {"w": ("d_model",), "b": ("d_model",)})
    return {"w": rng.full((d,), 1.0, dtype)}, {"w": ("d_model",)}


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)  # jnp.var: population
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["w"].float() + p["b"].float()).to(x.dtype)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    w = p["w"].float()
    if kind == "rmsnorm_gemma":
        w = 1.0 + w  # gemma zero-centred weight
    return (y * w).to(x.dtype)


# ----------------------------------------------------------------- rope --


def rope(x, positions, theta: float, fraction: float = 1.0):
    """Rotary embedding on the leading ``fraction`` of head dims.

    x: (..., S, H, D); positions: broadcastable to (..., S).
    """
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None, None].float() * freqs  # (...,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def softcap(x, cap: float | None):
    """Gemma-2 soft capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ------------------------------------------------------------ attention --


def init_attention(rng: Init, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    d, hd = cfg.d_model, cfg.head_dim_
    bias = cfg.qkv_bias
    p, s = {}, {}
    p["q"], s["q"] = init_linear(rng, d, cfg.n_heads * hd, dtype,
                                 ("d_model", "heads"), bias, ("heads",))
    p["k"], s["k"] = init_linear(rng, d, cfg.n_kv_heads * hd, dtype,
                                 ("d_model", "kv_heads"), bias, ("kv_heads",))
    p["v"], s["v"] = init_linear(rng, d, cfg.n_kv_heads * hd, dtype,
                                 ("d_model", "kv_heads"), bias, ("kv_heads",))
    p["o"], s["o"] = init_linear(rng, cfg.n_heads * hd, d, dtype,
                                 ("heads", "d_model"))
    return p, s


def _gqa_scores(q, k, scale, cap):
    """q: (B,Sq,KVH,G,D)  k: (B,Skv,KVH,D) -> (B,KVH,G,Sq,Skv) f32.

    The contraction runs in the input dtype and is upcast afterwards, as
    the reference's does (see the module docstring)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k)
    return softcap(s.float() * scale, cap)


def _mask(q_pos, k_pos, window):
    m = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _naive_attention(q, k, v, q_pos, k_pos, scale, cap, window, kv_valid):
    scores = _gqa_scores(q, k, scale, cap)
    mask = _mask(q_pos, k_pos, window)[None, None, None]  # (1,1,1,Sq,Skv)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", w, v)


def _chunked_attention(q, k, v, q_pos, k_pos, scale, cap, window, chunk):
    """Flash-style streaming over KV chunks: O(Sq * chunk) live scores.

    Never materializes the (Sq, Skv) score matrix. The reference's scan
    over chunks is a loop over views of k/v."""
    b, skv, kvh, d = k.shape
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2**30)

    g = q.shape[3]
    sq = q.shape[1]
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32, device=q.device)

    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kc_i, vc_i, kp_i = k[:, sl], v[:, sl], k_pos[sl]
        s = _gqa_scores(q, kc_i, scale, cap)  # (b,kvh,g,sq,chunk)
        msk = _mask(q_pos, kp_i, window)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows: keep m finite for exp arithmetic
        m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(msk, p, 0.0)
        corr = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - m_safe))
        l = l * corr + p.sum(-1)
        # the reference asks for an f32 result of a q.dtype product
        pv = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype).float(), vc_i.float())
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype)


def apply_attention(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    rules: ShardingRules | None,
    positions: torch.Tensor,
    window: int | None = None,
    impl: str = "naive",
    chunk: int = 1024,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Multi-head GQA attention with RoPE.

    Train/prefill: ``cache=None``, x is (B, S, d), positions (S,).
    Decode: ``cache`` holds k/v (B, S_max, KVH, D) + ``len`` 0-d int32;
    x is (B, 1, d) and positions (1,) == cache['len']. The token's k/v
    are written into ``cache["k"]`` / ``cache["v"]`` in place and
    ``cache["len"]`` is advanced in place; the cache is returned.

    Returns (output, updated_cache).
    """
    b, sq, _ = x.shape
    hd, kvh, g = cfg.head_dim_, cfg.n_kv_heads, cfg.q_per_kv
    q = linear(p["q"], x).reshape(b, sq, kvh, g, hd)
    k = linear(p["k"], x).reshape(b, sq, kvh, hd)
    v = linear(p["v"], x).reshape(b, sq, kvh, hd)

    q = rope(q.reshape(b, sq, kvh * g, hd), positions, cfg.rope_theta,
             cfg.rope_fraction).reshape(b, sq, kvh, g, hd)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    scale = 1.0 / math.sqrt(hd)

    new_cache = None
    if cache is None:
        k_pos = positions
        q_pos = positions
        kf, vf = k, v
        kv_valid = None
    else:
        # One-token decode: write k/v at index cache['len'], in place.
        idx = cache["len"]
        rows = idx.long() + torch.arange(sq, device=idx.device)
        kf, vf = cache["k"], cache["v"]
        kf.index_copy_(1, rows, k.to(kf.dtype))
        vf.index_copy_(1, rows, v.to(vf.dtype))
        s_max = kf.shape[1]
        k_pos = torch.arange(s_max, device=x.device)
        q_pos = positions
        kv_valid = (k_pos <= idx)[None, :]  # (1, S_max) broadcast over batch
        cache["len"].add_(sq)
        new_cache = cache

    kf = constrain(kf, rules, "act_kv_batch", "act_kv_seq", "act_kv_heads", None)
    vf = constrain(vf, rules, "act_kv_batch", "act_kv_seq", "act_kv_heads", None)

    if cache is None and impl == "chunked":
        out = _chunked_attention(q, kf, vf, q_pos, k_pos, scale,
                                 cfg.attn_softcap, window, chunk)
    else:
        out = _naive_attention(q, kf, vf, q_pos, k_pos, scale,
                               cfg.attn_softcap, window, kv_valid)
    out = out.reshape(b, sq, kvh * g * hd)
    return linear(p["o"], out), new_cache


def make_cache(cfg: ModelConfig, batch: int, s_max: int, dtype, device,
               lead: tuple[int, ...] = ()) -> dict:
    """Empty KV cache for one attention layer (``lead`` stacks layers)."""
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    lead = tuple(lead)
    return {
        "k": torch.zeros(lead + (batch, s_max, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros(lead + (batch, s_max, kvh, hd), dtype=dtype, device=device),
        "len": torch.zeros(lead, dtype=torch.int32, device=device),
    }


# ----------------------------------------------------------------- ffn --


def init_dense_ffn(rng: Init, cfg: ModelConfig, dtype, d_ff: int | None = None
                   ) -> tuple[dict, dict]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p, s = {}, {}
    if cfg.act in ("swiglu", "geglu"):
        p["wi_gate"], s["wi_gate"] = init_linear(rng, d, ff, dtype, ("d_model", "ffn"))
        p["wi_up"], s["wi_up"] = init_linear(rng, d, ff, dtype, ("d_model", "ffn"))
    else:  # relu2 (nemotron squared-ReLU), plain
        p["wi_up"], s["wi_up"] = init_linear(rng, d, ff, dtype, ("d_model", "ffn"))
    p["wo"], s["wo"] = init_linear(rng, ff, d, dtype, ("ffn", "d_model"))
    return p, s


def apply_dense_ffn(p, x, act: str):
    up = linear(p["wi_up"], x)
    if act == "swiglu":
        h = F.silu(linear(p["wi_gate"], x)) * up
    elif act == "geglu":
        h = F.gelu(linear(p["wi_gate"], x), approximate="tanh") * up  # jax's default
    elif act == "relu2":
        h = torch.square(F.relu(up))
    else:
        raise ValueError(act)
    return linear(p["wo"], h)


# ----------------------------------------------------------- embedding --


def init_embedding(rng: Init, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    p = {"table": rng.normal((cfg.vocab_size, cfg.d_model), cfg.d_model, dtype)}
    s = {"table": ("vocab", "d_model")}
    if not cfg.tie_embeddings:
        p["unembed"] = rng.normal((cfg.d_model, cfg.vocab_size), cfg.d_model, dtype)
        s["unembed"] = ("d_model", "vocab")
    return p, s
