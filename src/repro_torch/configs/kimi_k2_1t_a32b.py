"""Kimi K2 1T-A32B [moe] — 61L d=7168 64H (GQA kv=8) vocab=163840,
MoE 384 routed experts top-8, d_expert=2048 (paper-table entry; assigned
spec uses GQA rather than K2's MLA — recorded in DESIGN.md). First layer
dense, 60 scanned MoE layers. [arXiv:2501.kimi2 (paper table)]

Mirrors ``repro/configs/kimi_k2_1t_a32b.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,  # per-expert width
    vocab_size=163_840,
    prefix_layers=(("attn", "dense_wide"),),
    pattern=("attn",),
    ffn_pattern=("moe",),
    dense_ff_override=18432,
    act="swiglu",
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1),
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=256,
    prefix_layers=(("attn", "dense_wide"),),
    pattern=("attn",),
    ffn_pattern=("moe",),
    dense_ff_override=96,
    act="swiglu",
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=32, n_shared=1),
    tie_embeddings=False,
)


@register("kimi_k2_1t_a32b")
def _():
    return FULL, SMOKE
