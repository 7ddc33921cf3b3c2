"""Llama-3 405B [dense] — 126L d=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. GQA + SwiGLU + RoPE (theta 500k). [arXiv:2407.21783]

Mirrors ``repro/configs/llama3_405b.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=352,
    vocab_size=512,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=False,
)


@register("llama3_405b")
def _():
    return FULL, SMOKE
