"""The port's device rule.

Every entry point takes ``device=``. Left out, it means ``cuda``; when
CUDA is absent the entry point raises instead of running on the CPU, so a
missing card never turns into a silent CPU run. Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "upload"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Turn a ``device=`` argument into a ``torch.device``.

    ``None`` means ``cuda``. A CUDA device (given or defaulted) on a
    machine without CUDA raises ``RuntimeError``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def upload(array, device: torch.device) -> torch.Tensor:
    """A host numpy array as a tensor of its own on ``device``. A CUDA
    upload goes through pinned memory without blocking the host (a copy
    from pageable memory synchronises the stream); the caching host
    allocator keeps the pinned buffer alive until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)
