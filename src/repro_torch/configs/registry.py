"""Architecture registry: ``get(name)`` -> (full ModelConfig, smoke
ModelConfig). Every assigned architecture registers itself on import.

Mirrors ``repro/configs/registry.py``."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from repro_torch.models.config import ModelConfig

_REGISTRY: dict[str, Callable[[], tuple[ModelConfig, ModelConfig]]] = {}

ARCH_IDS = [
    "internvl2_2b",
    "musicgen_medium",
    "xlstm_350m",
    "deepseek_moe_16b",
    "kimi_k2_1t_a32b",
    "llama3_405b",
    "codeqwen15_7b",
    "nemotron4_15b",
    "gemma2_2b",
    "jamba15_large_398b",
    "sensor_gsp",  # the paper's own workload as a selectable config
]


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> ModelConfig:
    """Full-size config."""
    return _load(name)[0]


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _load(name)[1]


def _load(name: str):
    name = name.replace("-", "_").replace(".", "")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]()


def available() -> list[str]:
    return list(ARCH_IDS)
