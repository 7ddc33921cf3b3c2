"""Paper Sec. V applications on the port (mirrors ``repro/apps``)."""

from repro_torch.apps.denoising import (
    denoise_tikhonov,
    denoise_wiener,
    inverse_filter,
    smooth_heat,
    ssl_classify,
    wavelet_denoise_ista,
)
from repro_torch.apps.streaming import streaming_denoise, streaming_wavelet_denoise

__all__ = [
    "denoise_tikhonov",
    "denoise_wiener",
    "inverse_filter",
    "smooth_heat",
    "ssl_classify",
    "streaming_denoise",
    "streaming_wavelet_denoise",
    "wavelet_denoise_ista",
]
