"""The paper's own workload as a selectable config: a sensor-network
graph-signal-processing job (Chebyshev union-of-multipliers application)
rather than an LM. Used by the GSP-service dry-run and benchmarks.

This module exposes a lightweight dataclass (not a ModelConfig) because
the GSP engine has its own launch path (core.distributed).

Mirrors ``repro/configs/sensor_gsp.py``; the values are copied."""

import dataclasses

from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class SensorGSPConfig:
    n_vertices: int = 262_144        # production-scale field
    block_size: int = 128            # BSR tile (MXU-aligned)
    signal_batch: int = 128          # F simultaneous signals
    order: int = 20                  # paper: M ~ 20
    n_scales: int = 4                # SGWT bands (eta = 5)
    sigma: float = 0.074
    kappa: float = 0.075


FULL = SensorGSPConfig()
SMOKE = SensorGSPConfig(n_vertices=256, block_size=8, signal_batch=4,
                        order=10, n_scales=2, sigma=0.15, kappa=0.16)


@register("sensor_gsp")
def _():
    return FULL, SMOKE


# Keep ModelConfig import referenced (registry type hints expect it).
_ = ModelConfig
