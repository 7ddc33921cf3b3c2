"""Gemma-2 2B [dense] — 26L d=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Alternating local(4096-window)/global attention, GeGLU, logit softcaps
(attn 50, final 30), pre+post RMSNorm (zero-centred weights), sqrt(d)
embedding scaling, head_dim=256, tied embeddings. [arXiv:2408.00118]

Mirrors ``repro/configs/gemma2_2b.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    pattern=("local_attn", "attn"),
    ffn_pattern=("dense", "dense"),
    act="geglu",
    norm="rmsnorm_gemma",
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    pattern=("local_attn", "attn"),
    ffn_pattern=("dense", "dense"),
    act="geglu",
    norm="rmsnorm_gemma",
    window_size=16,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
    embed_scale=True,
)


@register("gemma2_2b")
def _():
    return FULL, SMOKE
