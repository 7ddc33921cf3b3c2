"""Deterministic synthetic data pipelines.

Mirrors ``repro/data/pipeline.py``.

* ``SyntheticTokenPipeline``: the global batch of a step is a function of
  ``(seed, step)`` alone, so a restarted job regenerates exactly the
  batches it would have seen (the data side of checkpoint/restart fault
  tolerance), whatever process, device or call order asks for it. The
  stream has the reference's learnable n-gram structure,
  ``(prev * 31 + base % 17) % V``, so small-model training loss falls
  measurably.
* ``sensor_field_batch``: random smooth fields plus noise on a sensor
  graph, for the paper's denoising workloads.
* ``make_batch_specs``: ``meta``-device stand-ins for every model input of
  a cell (shapes and dtypes, no memory), as ``models.lm.abstract_init``
  gives for the params.

The reference draws ``base`` from ``jax.random`` (threefry keyed on
``fold_in(PRNGKey(seed), step)``); the port draws it on the host from
numpy's ``default_rng([seed, step])``, so its batches are deterministic
per ``(seed, step)`` but are not the reference's. The token transform,
the label shift and the masked frontend labels are the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, ShapeConfig

__all__ = ["SyntheticTokenPipeline", "make_batch_specs", "sensor_field_batch", "token_transform"]


def token_transform(base: np.ndarray, vocab_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's Markov-ish stream from ``base`` (B, S + 1) ints:
    ``tokens_full = (roll(base, 1) * 31 + base % 17) % V``; returns
    ``(tokens, labels)``, int32 (B, S) each, the labels shifted by one."""
    base = np.asarray(base, dtype=np.int64)
    prev = np.roll(base, 1, axis=1)
    full = (prev * 31 + base % 17) % vocab_size
    return full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SyntheticTokenPipeline:
    """Stateless deterministic batch generator; batches land on
    ``device`` (default ``cuda``)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_positions: int = 0
    d_model: int = 0  # only needed when frontend_positions > 0
    device: str | torch.device | None = None

    def batch_at(self, step: int) -> dict:
        """Global batch for ``step``: ``tokens`` and ``labels`` (int32),
        plus ``extra_embeds`` (f32) when the model has frontend positions,
        whose labels are -1 (they carry no next-token loss)."""
        dev = resolve_device(self.device)
        rng = np.random.default_rng([self.seed, step])
        base = rng.integers(0, self.vocab_size, (self.global_batch, self.seq_len + 1))
        tokens, labels = token_transform(base, self.vocab_size)
        batch = {"tokens": tokens, "labels": labels}
        if self.frontend_positions:
            batch["extra_embeds"] = (0.02 * rng.standard_normal(
                (self.global_batch, self.frontend_positions, self.d_model))).astype(np.float32)
            labels[:, : self.frontend_positions] = -1
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16) -> dict:
    """``meta``-device tensors standing in for every model input of a cell."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": spec((b, s), i32), "labels": spec((b, s), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((b, s), i32)}
    elif shape.kind == "decode":
        return {"token": spec((b, 1), i32)}
    else:
        raise ValueError(shape.kind)
    if shape.frontend_positions:
        specs["extra_embeds"] = spec((b, shape.frontend_positions, cfg.d_model), dtype)
    return specs


def sensor_field_batch(gen: torch.Generator, coords: torch.Tensor, n_fields: int,
                       noise_std: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Smooth random quadratic fields + AWGN on sensor coordinates (N, 2),
    drawn from ``gen`` (a generator on ``coords``' device). Returns
    ``(clean, noisy)``, each (N, n_fields)."""
    coeffs = torch.randn((5, n_fields), generator=gen, device=coords.device)
    x, y = coords[:, 0:1], coords[:, 1:2]
    clean = (coeffs[0] * x**2 + coeffs[1] * y**2 + coeffs[2] * x * y
             + coeffs[3] * x + coeffs[4] * y)
    noisy = clean + noise_std * torch.randn(clean.shape, generator=gen, device=coords.device)
    return clean, noisy
