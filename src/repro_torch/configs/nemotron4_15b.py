"""Nemotron-4 15B [dense] — 32L d=6144 48H (GQA kv=8) d_ff=24576
vocab=256000. Squared-ReLU (non-gated) FFN, LayerNorm, partial (50%)
rotary, untied embeddings. [arXiv:2402.16819]

Mirrors ``repro/configs/nemotron4_15b.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256_000,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="relu2",
    norm="layernorm",
    rope_fraction=0.5,
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="relu2",
    norm="layernorm",
    rope_fraction=0.5,
    tie_embeddings=False,
)


@register("nemotron4_15b")
def _():
    return FULL, SMOKE
