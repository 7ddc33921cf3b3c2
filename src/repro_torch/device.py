"""The port's device rule.

Every entry point takes ``device=``. Left out, it means ``cuda``; when
CUDA is absent the entry point raises instead of running on the CPU, so a
missing card never turns into a silent CPU run. Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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

