"""The port's device rule.

Every entry point takes ``device=``. Left out, it means ``cuda``; when
CUDA is absent the entry point raises instead of running on the CPU, so a
missing card never turns into a silent CPU run. Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

__all__ = ["cached_upload", "pinned_uploads", "resolve_device", "upload"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Turn a ``device=`` argument into a ``torch.device``.

    ``None`` means ``cuda``. A CUDA device (given or defaulted) on a
    machine without CUDA raises ``RuntimeError``. ``cuda`` without an
    index names the current card (``cuda:0`` by default), as a tensor's
    ``.device`` does, so the result compares equal to the device of the
    tensors made on it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(array, device: torch.device) -> torch.Tensor:
    """A host numpy array as a tensor of its own on ``device``. A CUDA
    upload goes through pinned memory without blocking the host (a copy
    from pageable memory synchronises the stream); the caching host
    allocator keeps the pinned buffer alive until the copy has run.
    ``pin_memory`` cannot run while a CUDA graph is being recorded, so a
    recorded program takes tensors already on the card."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


_pin_sets: list[dict] = []


@contextlib.contextmanager
def pinned_uploads():
    """Collect every tensor ``cached_upload`` hands out inside the block.

    Yields a dict (``id`` -> tensor) that the caller keeps for as long as
    something reads those tensors by address. A recorded CUDA graph does:
    it holds raw device pointers, and once the upload cache evicts an
    entry nobody else holds, its memory goes back to the allocator while
    every later replay would still read it.
    """
    held: dict[int, torch.Tensor] = {}
    _pin_sets.append(held)
    try:
        yield held
    finally:
        _pin_sets.remove(held)


@functools.lru_cache(maxsize=64)
def _cached_upload(raw: bytes, shape: tuple, src: str, device: torch.device, dtype) -> torch.Tensor:
    host = torch.from_numpy(np.frombuffer(raw, dtype=src).reshape(shape).copy())
    return host.to(dtype).to(device)


def cached_upload(array, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A small host array (coefficients, weights) as a ``dtype`` tensor on
    ``device``, uploaded once per distinct content rather than once per
    call: a copy from pageable memory synchronises the stream, and none
    may run while a CUDA graph is being recorded. The cast to ``dtype``
    happens on the host (the same rounding as on the card). The tensor is
    shared between callers: never write into it. The cache holds 64
    entries; a caller that keeps reading one by address after later
    uploads (a recorded CUDA graph) keeps it with ``pinned_uploads``."""
    a = np.ascontiguousarray(array)
    t = _cached_upload(a.tobytes(), a.shape, a.dtype.str, torch.device(device), dtype)
    for held in _pin_sets:
        held[id(t)] = t
    return t
