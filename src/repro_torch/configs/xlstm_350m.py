"""xLSTM 350M [ssm] — 24L d=1024 4H d_ff=0 vocab=50304. sLSTM + mLSTM
blocks in the paper's xLSTM[7:1] ratio (7 mLSTM : 1 sLSTM per 8-layer
group); blocks embed their own channel mixing (d_ff = 0).
[arXiv:2405.04517]

Mirrors ``repro/configs/xlstm_350m.py``; the values are copied."""

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

_PATTERN = ("mlstm",) * 7 + ("slstm",)
_FFN = ("none",) * 8

FULL = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=_PATTERN,
    ffn_pattern=_FFN,
    norm="layernorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    pattern=_PATTERN,
    ffn_pattern=_FFN,
    norm="layernorm",
)


@register("xlstm_350m")
def _():
    return FULL, SMOKE
