"""Optimisers of the port (mirrors ``repro/optim``)."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    adamw_update_,
    clip_by_global_norm,
    cosine_schedule,
    init_opt_state,
    opt_state_specs,
)

__all__ = [
    "AdamWConfig", "adamw_update", "adamw_update_", "clip_by_global_norm",
    "cosine_schedule", "init_opt_state", "opt_state_specs",
]
