"""MusicGen-medium [audio] — decoder-only over EnCodec tokens: 48L d=1536
24H (MHA kv=24) d_ff=6144 vocab=2048. The EnCodec frontend is a STUB:
``input_specs()`` supplies 256 precomputed conditioning-frame embeddings
replacing the first positions; the remaining positions are EnCodec code
tokens. MusicGen uses learned pos-emb + cross-attn in the original; the
assigned backbone here is the causal decoder stack. [arXiv:2306.05284]

Mirrors ``repro/configs/musicgen_medium.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="geglu",
    norm="layernorm",
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

FRONTEND_POSITIONS = 256

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=256,
    pattern=("attn",),
    ffn_pattern=("dense",),
    act="geglu",
    norm="layernorm",
    tie_embeddings=False,
)


@register("musicgen_medium")
def _():
    return FULL, SMOKE
