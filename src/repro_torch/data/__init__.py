"""Deterministic data pipelines of the port (mirrors ``repro/data``)."""

from repro_torch.data.pipeline import (
    SyntheticTokenPipeline,
    make_batch_specs,
    sensor_field_batch,
    token_transform,
)

__all__ = ["SyntheticTokenPipeline", "make_batch_specs", "sensor_field_batch", "token_transform"]
