"""Assigned-architecture configs (exact published numbers) + smoke variants.

Mirrors ``repro/configs/__init__.py``."""

from repro_torch.configs.registry import ARCH_IDS, available, get, get_smoke

__all__ = ["ARCH_IDS", "available", "get", "get_smoke"]
