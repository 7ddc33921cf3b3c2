"""InternVL2-2B [vlm] — InternLM2-1.8B backbone: 24L d=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553. The InternViT frontend is a STUB per the brief:
``input_specs()`` supplies 256 precomputed patch embeddings that replace
the first 256 token positions. [arXiv:2404.16821]

Mirrors ``repro/configs/internvl2_2b.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,  # InternLM2-1.8B ties embeddings
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

# Frontend stub: patch embeddings for the first N positions.
FRONTEND_POSITIONS = 256

SMOKE = ModelConfig(
    name="internvl2-2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="swiglu",
)


@register("internvl2_2b")
def _():
    return FULL, SMOKE
