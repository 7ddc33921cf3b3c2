"""Model/shape/parallelism configuration dataclasses.

Mirrors ``repro/models/config.py`` field for field. One ``ModelConfig``
instance fully determines an architecture; the assigned architectures
live in ``repro_torch/configs/<id>.py`` with the exact published numbers.
The reference's ``dtype()`` / ``pdtype()`` return jax dtypes; here they
return the torch dtypes of the same names.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Literal, Sequence

import torch

__all__ = ["MoEConfig", "DroplessMoEConfig", "MambaConfig", "ModelConfig", "YarnRope",
           "MLAConfig", "MLAModelConfig", "ShapeConfig", "ParallelConfig", "LayerKind",
           "torch_dtype"]

# Layer kinds a block pattern can contain ("mla": multi-head latent
# attention, in an ``MLAModelConfig`` only).
LayerKind = Literal["attn", "local_attn", "mla", "mamba", "mlstm", "slstm"]
ATTENTION_KINDS = ("attn", "local_attn", "mla")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config's dtype string names."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (GShard/DeepSeek style)."""

    n_experts: int
    top_k: int
    d_expert: int                 # per-expert hidden width
    n_shared: int = 0             # always-on shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    router_noise: float = 0.0

    # The reference's routing rule: the top-k gates renormalised to sum to
    # one, a per-expert capacity buffer that drops tokens past it.
    # ``DroplessMoEConfig`` changes both; they are class attributes here,
    # so that ``dataclasses.asdict`` of every reference config keeps the
    # reference's fields.
    norm_topk: ClassVar[bool] = True
    dropless: ClassVar[bool] = False

    @property
    def active_experts(self) -> int:
        return self.top_k + self.n_shared


@dataclasses.dataclass(frozen=True)
class DroplessMoEConfig(MoEConfig):
    """DeepSeek-V2's router: softmax scores, greedy top-k, the chosen
    scores renormalised only where ``norm_topk``; no token is dropped at
    any batch size (each expert computes exactly the tokens routed to it;
    ``capacity_factor`` is unused)."""

    norm_topk: bool = False
    dropless: ClassVar[bool] = True


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM layer configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None    # defaults to ceil(d_model / 16)

    def inner(self, d_model: int) -> int:
        return self.expand * d_model

    def rank(self, d_model: int) -> int:
        return self.dt_rank or max(d_model // 16, 1)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture definition (family-agnostic superset)."""

    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # Block pattern: the smallest repeating layer sequence. n_layers ==
    # n_prefix_layers + len(pattern) * repeats. Each entry is a LayerKind.
    pattern: Sequence[str] = ("attn",)
    # FFN kind per pattern entry: 'dense' | 'moe' | 'none' (for xLSTM whose
    # blocks embed their own channel mixing).
    ffn_pattern: Sequence[str] = ("dense",)
    # Unscanned prefix layers (e.g. DeepSeekMoE's dense first layer):
    # (layer_kind, ffn_kind) pairs.
    prefix_layers: Sequence[tuple[str, str]] = ()

    head_dim: int | None = None   # defaults to d_model // n_heads
    norm: str = "rmsnorm"         # rmsnorm | layernorm | rmsnorm_gemma
    act: str = "swiglu"           # swiglu | geglu | relu2
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0    # nemotron: 0.5 partial rotary
    window_size: int = 4096       # for local_attn layers
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    post_block_norm: bool = False  # gemma2 post-norms
    embed_scale: bool = False      # gemma2 sqrt(d) embedding multiplier
    tie_embeddings: bool = True
    dense_ff_override: int | None = None  # prefix dense layer width if != d_ff

    moe: MoEConfig | None = None
    mamba: MambaConfig = MambaConfig()

    # xLSTM block shaping
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "float32"

    def __post_init__(self):
        body = self.n_layers - len(self.prefix_layers)
        if body % len(self.pattern) != 0:
            raise ValueError(f"{self.name}: {body} body layers not divisible by pattern "
                             f"{len(self.pattern)}")
        if len(self.ffn_pattern) != len(self.pattern):
            raise ValueError(f"{self.name}: ffn_pattern and pattern differ in length")

    @property
    def repeats(self) -> int:
        return (self.n_layers - len(self.prefix_layers)) // len(self.pattern)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: {self.n_heads} heads over {self.n_kv_heads} kv heads")
        return self.n_heads // self.n_kv_heads

    @property
    def has_attention(self) -> bool:
        kinds = list(self.pattern) + [k for k, _ in self.prefix_layers]
        return any(k in ATTENTION_KINDS for k in kinds)

    @property
    def pure_full_attention(self) -> bool:
        """True if every mixing layer is (possibly windowed or latent)
        softmax attention AND at least one layer is global full attention."""
        kinds = list(self.pattern) + [k for k, _ in self.prefix_layers]
        return all(k in ATTENTION_KINDS for k in kinds) and (
            "attn" in kinds or "mla" in kinds)

    def dtype(self) -> torch.dtype:
        return torch_dtype(self.activation_dtype)

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)


@dataclasses.dataclass(frozen=True)
class YarnRope:
    """YaRN rotary scaling (arXiv:2309.00071, DeepSeek-V2's variant):
    positions past ``original_max_position`` interpolated by ``factor``
    on the low frequencies, the high ones kept, a linear ramp between
    the dimensions that ``beta_fast`` and ``beta_slow`` rotations bound."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434): keys
    and values come up from one ``kv_lora_rank``-wide latent per token;
    each head's query and key are a ``qk_nope_head_dim`` part and a
    ``qk_rope_head_dim`` rotary part whose key all heads share."""

    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_scaling: YarnRope | None = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a latent cache holds per token and layer: the latent and
        the shared rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class MLAModelConfig(ModelConfig):
    """A ``ModelConfig`` whose ``mla`` layers take their widths from ``mla``
    (a subclass, so that the reference's configs keep their fields)."""

    mla: MLAConfig | None = None

    def __post_init__(self):
        super().__post_init__()
        if self.mla is None:
            raise ValueError(f"{self.name}: an MLAModelConfig needs mla=")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell's input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
    # For [vlm]/[audio] stubs: number of leading positions whose embeddings
    # come from the (stubbed) modality frontend instead of the token table.
    frontend_positions: int = 0


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Distribution + memory-policy knobs (the §Perf hillclimb levers).

    On one device only ``attn_impl``, ``attn_chunk``, ``mamba_chunk``,
    ``moe_groups`` and ``moe_capacity`` change what the port computes;
    the rest are kept so that configs carry across from the reference."""

    fsdp: bool = True                  # shard params/opt over data axis
    seq_parallel: bool = True          # shard residual seq dim over 'model'
    attn_impl: str = "chunked"         # naive | chunked
    attn_chunk: int = 1024
    remat: str = "block"               # none | block (checkpoint each group)
    microbatches: int = 1              # grad-accumulation steps
    optimizer_dtype: str = "float32"   # float32 | bfloat16 moments
    grad_sync: str = "allreduce"       # allreduce | gossip | local_sgd
    gossip_order: int | None = None
    gossip_buckets: int = 1            # flat size-balanced gradient buckets
    gossip_overlap: bool = False       # pipeline bucket sync w/ backward
    gossip_payload_dtype: str | None = None  # e.g. "bfloat16" exchanges
    gossip_truncate: int = 0           # drop last r rounds (staleness)
    mamba_chunk: int = 256
    moe_groups: int = 1                # MoE dispatch groups (= DP shards)
    moe_capacity: float = 0.0          # >0 overrides MoEConfig.capacity_factor
    moe_dense_fallback: bool = False   # route-all (debug / tiny smoke)
