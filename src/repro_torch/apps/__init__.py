"""Paper Sec. V applications on the port (mirrors ``repro/apps``)."""

from repro_torch.apps.denoising import (
    denoise_tikhonov,
    denoise_wiener,
    inverse_filter,
    smooth_heat,
    ssl_classify,
    wavelet_denoise_ista,
)

__all__ = [
    "denoise_tikhonov",
    "denoise_wiener",
    "inverse_filter",
    "smooth_heat",
    "ssl_classify",
    "wavelet_denoise_ista",
]
