"""The benchmark run matrix: (architecture x input shape) cells with
per-cell parallelism defaults and skip rules (DESIGN.md Sec. 5).

Mirrors ``repro/launch/cells.py``; the lists, rules and skip reasons are
the reference's."""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ALL_SHAPES, ParallelConfig, ShapeConfig

__all__ = ["CELLS", "Cell", "iter_cells", "cell_skip_reason",
           "default_parallel", "shape_with_frontend", "FRONTEND", "LM_ARCHS"]

LM_ARCHS = [
    "internvl2_2b", "musicgen_medium", "xlstm_350m", "deepseek_moe_16b",
    "kimi_k2_1t_a32b", "llama3_405b", "codeqwen15_7b", "nemotron4_15b",
    "gemma2_2b", "jamba15_large_398b",
]

# [vlm]/[audio] stub frontends: positions carrying precomputed embeddings.
FRONTEND = {"internvl2_2b": 256, "musicgen_medium": 256}

# Sub-quadratic rule: long_500k only for SSM/hybrid stacks (gemma2's
# alternating local/global still contains full-attention layers -> skipped).
_LONG_OK = {"xlstm_350m", "jamba15_large_398b"}


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeConfig

    @property
    def name(self) -> str:
        return f"{self.arch}.{self.shape.name}"


CELLS = [Cell(a, s) for a in LM_ARCHS for s in ALL_SHAPES]


def cell_skip_reason(cell: Cell) -> str | None:
    if cell.shape.name == "long_500k" and cell.arch not in _LONG_OK:
        return "long_500k requires sub-quadratic attention (full-attention stack)"
    return None


def iter_cells(runnable_only: bool = True):
    for c in CELLS:
        if runnable_only and cell_skip_reason(c):
            continue
        yield c


def default_parallel(arch: str, shape: ShapeConfig, **overrides) -> ParallelConfig:
    """Baseline per-cell parallel policy (the hill-climb's starting point).

    Baseline: FSDP + remat + naive attention, no SP, no microbatching.
    Hill-climbs override via **overrides.
    """
    base = dict(
        fsdp=True,
        remat="block",
        attn_impl="naive",
        seq_parallel=False,
        microbatches=1,
        optimizer_dtype="float32",
        grad_sync="allreduce",
        mamba_chunk=1024,
    )
    if shape.kind != "train":
        base["remat"] = "none"
        # fsdp stays on for serving too: weights sharded over data x model
        # and gathered per layer group on use (required for the >=398B
        # models whose TP-only shards exceed a card's memory).
    if shape.name == "long_500k":
        base["mamba_chunk"] = 4096
    base.update(overrides)
    return ParallelConfig(**base)


def shape_with_frontend(arch: str, shape: ShapeConfig) -> ShapeConfig:
    fp = FRONTEND.get(arch, 0)
    if fp and shape.kind in ("train", "prefill"):
        return dataclasses.replace(shape, frontend_positions=fp)
    return shape
