"""PyTorch/CUDA port of the ``repro`` package (Chebyshev polynomial
approximation for distributed graph signal processing).

The JAX package ``repro`` is the reference; each module here names the
reference file it mirrors. This package imports ``torch``, numpy and
scipy only, never ``jax`` and nothing from ``repro``. Entry points run on
``cuda`` unless the caller passes ``device=`` (see ``repro_torch.device``).
The two Block-ELL Chebyshev kernels are CUDA C++ for ``sm_90a``
(``repro_torch/kernels/csrc/cheb_bsr.cu``), built on first use.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
