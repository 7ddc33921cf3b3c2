"""CodeQwen1.5-7B [dense] — 32L d=4096 32H (MHA kv=32) d_ff=13440
vocab=92416. Qwen1.5 arch: QKV bias, SwiGLU, RoPE theta 1e6.
[hf:Qwen/CodeQwen1.5-7B]

Mirrors ``repro/configs/codeqwen15_7b.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=320,
    vocab_size=512,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
)


@register("codeqwen15_7b")
def _():
    return FULL, SMOKE
