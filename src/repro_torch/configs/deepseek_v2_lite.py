"""DeepSeek-V2-Lite [moe] — 27L d=2048 16H, multi-head latent attention
(kv_lora_rank 512, no q_lora; qk 128 + rope 64, v 128; YaRN factor 40
over 4096 positions, mscale 0.707), vocab=102400 untied; the first layer
a dense SwiGLU FFN (width 10944), then 26 MoE layers of 64 routed experts
(width 1408, greedy top-6 over softmax scores, not renormalised, scale 1)
and 2 shared; RMSNorm eps 1e-6. 15.7 B parameters, 2.4 B active per token.
[arXiv:2405.04434; huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json]

No counterpart in the reference package: latent attention and the
dropless router exist in the port only.
"""

from repro_torch.configs.registry import register
from repro_torch.models.config import DroplessMoEConfig, MLAConfig, MLAModelConfig, YarnRope

FULL = MLAModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert width (assigned-table convention)
    vocab_size=102_400,
    prefix_layers=(("mla", "dense_wide"),),
    pattern=("mla",),
    ffn_pattern=("moe",),
    dense_ff_override=10944,
    act="swiglu",
    rope_theta=10_000.0,
    moe=DroplessMoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                          norm_topk=False),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                  rope_scaling=YarnRope(factor=40.0, original_max_position=4096, beta_fast=32.0,
                                        beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)),
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = MLAModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab_size=256,
    prefix_layers=(("mla", "dense_wide"),),
    pattern=("mla",),
    ffn_pattern=("moe",),
    dense_ff_override=128,
    act="swiglu",
    moe=DroplessMoEConfig(n_experts=8, top_k=3, d_expert=48, n_shared=2),
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                  rope_scaling=YarnRope(factor=40.0, original_max_position=64, mscale=0.707,
                                        mscale_all_dim=0.707)),
    tie_embeddings=False,
)


@register("deepseek_v2_lite")
def _():
    return FULL, SMOKE
