"""Jamba-1.5 Large 398B [hybrid] — 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536. Mamba:attn 1:7 interleave (8-layer blocks, attention at
index 4), MoE 16 experts top-2 on every other layer. [arXiv:2403.19887]

Mirrors ``repro/configs/jamba15_large_398b.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig

# 8-layer Jamba block: attention sits at position 4; MoE every 2nd layer.
_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
            "mamba")
_FFN = ("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe")

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    ffn_pattern=_FFN,
    act="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    pattern=_PATTERN,
    ffn_pattern=_FFN,
    act="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    tie_embeddings=False,
)


@register("jamba15_large_398b")
def _():
    return FULL, SMOKE
