"""DeepSeek-V2's decoder in plain PyTorch and float32: the reference of the
``lm_sessions`` program.

The configuration is a Hugging Face ``config.json`` dict (the keys of
``configs/deepseek_v2_lite.json``). The equations are the authors'
``modeling_deepseek.py`` (DeepSeek-V2 repository; arXiv:2405.04434 Sec. 2):

* RMSNorm (``rms_norm_eps``) before attention and before the FFN, residual
  adds after each; a final RMSNorm and an untied head;
* multi-head latent attention without ``q_lora``: ``q = W_q h`` (per head
  ``qk_nope_head_dim + qk_rope_head_dim``), ``[c; k_pe] = W_kv_a h``,
  ``c`` RMS-normed, ``[k_nope; v] = W_kv_b c`` per head, one rotary key
  ``k_pe`` for all heads, YaRN inverse frequencies (``yarn_inv_freq``),
  scores ``softmax_scale * (q_nope . k_nope + q_pe . k_pe)``, a causal
  softmax, ``W_o`` over the heads' ``sum p v``;
* the first ``first_k_dense_replace`` layers a SwiGLU FFN of
  ``intermediate_size``; the others ``n_routed_experts`` SwiGLU experts of
  ``moe_intermediate_size``, scored by a softmax over ``h W_r`` in float32,
  the greedy top ``num_experts_per_tok`` weighted by their scores
  (renormalised only where ``norm_topk_prob``) times
  ``routed_scaling_factor``, plus ``n_shared_experts`` shared experts as
  one SwiGLU of ``n_shared_experts * moe_intermediate_size``.

Departures from the published description:

* the weights are seeded random data (``layer_weights``, ``top_weights``),
  drawn in bfloat16 as the checkpoint is stored, and upcast here;
* no cache and no batching: one sequence's whole causal forward, the
  expanded attention with its queries taken in blocks (``QUERY_BLOCK``) so
  the scores fit, and logits only at the positions asked for;
* the rotary pairs are interleaved, ``(2i, 2i + 1)``: the authors' code
  de-interleaves ``q_pe`` and ``k_pe`` alike before a half-split rotation,
  which leaves every score as it is;
* ``q_lora_rank``, group-limited routing (``topk_method`` other than
  ``greedy``) and the auxiliary losses are not implemented (refused).

``precision="fp8"`` is the control, one step below the configuration's
bfloat16: every matrix product's operands and the latent cache's rows
rounded to float8_e4m3fn, each tensor with its own scale. Matrix products
run with TF32 off. Nothing of the program is imported.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["PRECISIONS", "QUERY_BLOCK", "yarn_inv_freq", "softmax_scale", "layer_weights",
           "top_weights", "embed", "block", "logits_at", "forward", "full_f32", "round_fp8"]

PRECISIONS = ("float32", "fp8")
QUERY_BLOCK = 512
_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


@contextlib.contextmanager
def full_f32():
    """Matrix products and convolutions in full float32 (TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn with a per-tensor scale (its largest
    magnitude onto 448), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = round_fp8(a), round_fp8(b)
    return a @ b


def _check(cfg: dict) -> None:
    if cfg.get("q_lora_rank") is not None:
        raise ValueError("q_lora_rank is not implemented")
    if cfg.get("topk_method", "greedy") != "greedy" or cfg.get("scoring_func") != "softmax":
        raise ValueError("only greedy top-k over softmax scores is implemented")


def _yarn_m(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: dict) -> torch.Tensor:
    """(qk_rope_head_dim // 2,) float32 inverse frequencies, in float64 on
    the host: ``corr(r) = d ln(L0 / (2 pi r)) / (2 ln theta)``, ``low =
    floor(corr(beta_fast))`` and ``high = ceil(corr(beta_slow))`` clamped to
    [0, d - 1], ``ramp_i = clamp((i - low) / (high - low), 0, 1)``, and
    ``theta_i / factor * ramp_i + theta_i * (1 - ramp_i)``."""
    d, theta = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    base = [theta ** (-2.0 * i / d) for i in range(d // 2)]
    y = cfg.get("rope_scaling")
    if not y:
        return torch.tensor(base, dtype=torch.float64).float()
    l0 = y["original_max_position_embeddings"]

    def corr(rotations):
        return d * math.log(l0 / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(y.get("beta_fast", 32))), 0)
    high = min(math.ceil(corr(y.get("beta_slow", 1))), d - 1)
    if low == high:
        high += 0.001
    ramp = [min(max((i - low) / (high - low), 0.0), 1.0) for i in range(d // 2)]
    freq = [b / y["factor"] * r + b * (1.0 - r) for b, r in zip(base, ramp)]
    return torch.tensor(freq, dtype=torch.float64).float()


def softmax_scale(cfg: dict) -> float:
    """``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5 * m ** 2``, ``m =
    0.1 * mscale_all_dim * ln(factor) + 1`` under YaRN."""
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    y = cfg.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        scale *= _yarn_m(y["factor"], y["mscale_all_dim"]) ** 2
    return scale


def _cos_sin_scale(cfg: dict) -> float:
    y = cfg.get("rope_scaling")
    if not y:
        return 1.0
    return _yarn_m(y["factor"], y.get("mscale", 1.0)) / _yarn_m(y["factor"],
                                                               y.get("mscale_all_dim", 0.0))


# ------------------------------------------------------------- weights --


def _generator(seed: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + index) % 2**63)


def _normal(gen, shape, fan_in, device, dtype):
    return (torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)).to(dtype)


def _norm_weight(gen, n, device, dtype):
    return (1.0 + 0.1 * torch.randn((n,), generator=gen, device=device)).to(dtype)


def layer_weights(cfg: dict, seed: int, layer: int, device, dtype=torch.bfloat16) -> dict:
    """Layer ``layer``'s weights, drawn from the run's ``seed`` alone (any
    layer can be drawn again without the others): matrices N(0, 1 /
    fan_in), norm weights 1 + N(0, 0.01), in ``dtype``. A product is
    ``x @ W``, W (in, out); experts are stacked, (E, in, out)."""
    _check(cfg)
    gen = _generator(seed, layer + 1, device)
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])

    def normal(shape, fan_in):
        return _normal(gen, shape, fan_in, device, dtype)

    w = {
        "attn_norm": _norm_weight(gen, d, device, dtype),
        "wq": normal((d, h * (dn + dr)), d),
        "wkv_a": normal((d, r + dr), d),
        "kv_norm": _norm_weight(gen, r, device, dtype),
        "wkv_b": normal((r, h * (dn + dv)), r),
        "wo": normal((h * dv, d), h * dv),
        "ffn_norm": _norm_weight(gen, d, device, dtype),
    }
    if layer < cfg["first_k_dense_replace"]:
        f = cfg["intermediate_size"]
        w.update(w_gate=normal((d, f), d), w_up=normal((d, f), d), w_down=normal((f, d), f))
    else:
        e, de, fs = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
                     cfg["n_shared_experts"] * cfg["moe_intermediate_size"])
        w.update(router=normal((d, e), d), experts_gate=normal((e, d, de), d),
                 experts_up=normal((e, d, de), d), experts_down=normal((e, de, d), de),
                 shared_gate=normal((d, fs), d), shared_up=normal((d, fs), d),
                 shared_down=normal((fs, d), fs))
    return w


def top_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The embedding (V, d), the final norm and the untied head (d, V)."""
    gen = _generator(seed, 0, device)
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return {"embed": _normal(gen, (v, d), d, device, dtype),
            "final_norm": _norm_weight(gen, d, device, dtype),
            "head": _normal(gen, (d, v), d, device, dtype)}


# ------------------------------------------------------------- forward --


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, positions, inv_freq, mscale):
    """Rotate interleaved pairs of x (S, ..., D) by positions (S,)."""
    ang = positions.to(torch.float32)[:, None] * inv_freq.to(x.device)
    ang = ang.view(ang.shape[0], *([1] * (x.dim() - 2)), ang.shape[1])
    cos, sin = torch.cos(ang) * mscale, torch.sin(ang) * mscale
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1).flatten(-2)


def _swiglu(x, gate, up, down, precision):
    return _mm(F.silu(_mm(x, gate, precision)) * _mm(x, up, precision), down, precision)


def _attention(w, x, positions, cfg, precision):
    s = x.shape[0]
    h, dn, dr, dv, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                        cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
    inv_freq, mscale = yarn_inv_freq(cfg), _cos_sin_scale(cfg)
    q = _mm(x, w["wq"], precision).view(s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], _rope(q[..., dn:], positions, inv_freq, mscale)
    ckv = _mm(x, w["wkv_a"], precision)
    c = _rms(ckv[:, :r], w["kv_norm"], cfg["rms_norm_eps"])
    k_pe = _rope(ckv[:, r:], positions, inv_freq, mscale)
    if precision == "fp8":  # the latent cache's rows
        c, k_pe = round_fp8(c), round_fp8(k_pe)
    kv = _mm(c, w["wkv_b"], precision).view(s, h, dn + dv)
    k_nope, v = kv[..., :dn].transpose(0, 1), kv[..., dn:].transpose(0, 1)  # (H, S, .)
    scale = softmax_scale(cfg)
    out = torch.empty((s, h, dv), dtype=x.dtype, device=x.device)
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, s)
        scores = (_mm(q_nope[q0:q1].transpose(0, 1), k_nope[:, :q1].transpose(1, 2), precision)
                  + _mm(q_pe[q0:q1].transpose(0, 1), k_pe[:q1].T, precision)) * scale
        causal = positions[q0:q1, None] >= positions[None, :q1]
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out[q0:q1] = _mm(p, v[:, :q1], precision).transpose(0, 1)
    return _mm(out.reshape(s, h * dv), w["wo"], precision)


def _moe(w, x, cfg, precision):
    k = cfg["num_experts_per_tok"]
    scores = torch.softmax(_mm(x, w["router"], precision), dim=-1)
    top_w, top_i = torch.topk(scores, k, dim=-1)
    if cfg["norm_topk_prob"]:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    top_w = top_w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            ye = _swiglu(x[tok], w["experts_gate"][e], w["experts_up"][e],
                         w["experts_down"][e], precision)
            y.index_add_(0, tok, ye * top_w[tok, slot, None])
    return y + _swiglu(x, w["shared_gate"], w["shared_up"], w["shared_down"], precision)


def embed(top: dict, tokens: torch.Tensor) -> torch.Tensor:
    """(S,) ids -> (S, d) float32."""
    return top["embed"][tokens].float()


def block(w: dict, x: torch.Tensor, positions: torch.Tensor, cfg: dict, layer: int,
          precision: str = "float32") -> torch.Tensor:
    """Layer ``layer`` on x (S, d) float32 at positions (S,); its weights
    ``w`` (any dtype) are upcast to float32 here."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    w = {name: t.float() for name, t in w.items()}
    eps = cfg["rms_norm_eps"]
    with full_f32():
        x = x + _attention(w, _rms(x, w["attn_norm"], eps), positions, cfg, precision)
        h = _rms(x, w["ffn_norm"], eps)
        if layer < cfg["first_k_dense_replace"]:
            return x + _swiglu(h, w["w_gate"], w["w_up"], w["w_down"], precision)
        return x + _moe(w, h, cfg, precision)


def logits_at(top: dict, x: torch.Tensor, at, cfg: dict, precision: str = "float32"):
    """The logits (len(at), V) float32 at the positions ``at`` of x (S, d)."""
    h = _rms(x[at], top["final_norm"].float(), cfg["rms_norm_eps"])
    with full_f32():
        return _mm(h, top["head"].float(), precision)


def forward(cfg: dict, weights, top: dict, tokens: torch.Tensor, at,
            precision: str = "float32") -> torch.Tensor:
    """The logits (len(at), V) of one sequence tokens (S,): ``weights(i)``
    gives layer i's weights (drawn or held by the caller)."""
    x = embed(top, tokens)
    positions = torch.arange(tokens.shape[0], device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        x = block(weights(i), x, positions, cfg, i, precision)
    return logits_at(top, x, at, cfg, precision)
