"""Paper Sec. V applications on the port (mirrors ``repro/apps``)."""

from repro_torch.apps.denoising import denoise_tikhonov, smooth_heat, ssl_classify

__all__ = ["denoise_tikhonov", "smooth_heat", "ssl_classify"]
