"""DeepSeekMoE 16B [moe] — 28L d=2048 16H (kv=16) vocab=102400,
fine-grained MoE: 64 routed top-6 + 2 shared experts, d_expert=1408;
first layer is a dense SwiGLU FFN (width 10944). [arXiv:2401.06066]

Mirrors ``repro/configs/deepseek_moe_16b.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert width (assigned-table convention)
    vocab_size=102_400,
    prefix_layers=(("attn", "dense_wide"),),
    pattern=("attn",),
    ffn_pattern=("moe",),
    dense_ff_override=10944,
    act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab_size=256,
    prefix_layers=(("attn", "dense_wide"),),
    pattern=("attn",),
    ffn_pattern=("moe",),
    dense_ff_override=128,
    act="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=48, n_shared=1),
    tie_embeddings=False,
)


@register("deepseek_moe_16b")
def _():
    return FULL, SMOKE
