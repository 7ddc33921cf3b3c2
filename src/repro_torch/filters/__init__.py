"""Unified graph-filter layer of the port: one ``GraphFilter`` surface,
several backends (mirrors ``repro/filters``). Importing this package
registers the ``dense``, ``bsr``, ``halo``, ``allgather``, ``grid`` and
``matvec`` backends."""

from repro_torch.filters.api import (
    CudaGraphProgram,
    GraphFilter,
    bucket_size,
    gather_reach,
    shift_matvec_counts,
)
from repro_torch.filters.registry import (
    BackendCapabilities,
    FilterBackend,
    available_backends,
    backend_capabilities,
    backend_is_traceable,
    backend_supports_multi_shift,
    backend_supports_sparse,
    get_backend,
    register_backend,
    require_capability,
)
from repro_torch.filters import backends as _backends  # noqa: F401  (registers)

__all__ = [
    "BackendCapabilities",
    "CudaGraphProgram",
    "FilterBackend",
    "GraphFilter",
    "available_backends",
    "backend_capabilities",
    "backend_is_traceable",
    "backend_supports_multi_shift",
    "backend_supports_sparse",
    "bucket_size",
    "gather_reach",
    "get_backend",
    "register_backend",
    "require_capability",
    "shift_matvec_counts",
]
