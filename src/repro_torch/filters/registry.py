"""Backend registry for :class:`repro_torch.filters.GraphFilter`.

Mirrors ``repro/filters/registry.py``. A backend packages how ``Phi~ f``
and ``Phi~* a`` are evaluated (dense matmul, Block-ELL kernels, a caller's
matvec) behind a small protocol; the spectral data lives on the filter and
the graph-operator data is backend state built once by ``prepare``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol, Sequence, runtime_checkable

import torch

__all__ = [
    "BackendCapabilities",
    "FilterBackend",
    "register_backend",
    "get_backend",
    "available_backends",
    "backend_capabilities",
    "backend_is_traceable",
    "backend_supports_sparse",
    "backend_supports_multi_shift",
    "require_capability",
]


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a registered backend can do, as one frozen record.

    Attributes
    ----------
    traceable : bool
        True iff apply/adjoint/gram run device ops only (no host round
        trip), so solver loops may keep their state on the device
        (``solvers/loops.py`` then records histories as the reference's
        compiled loops do).
    sparse_input : bool
        True iff the backend implements ``apply_sparse``: the recurrence
        restricted to the order-hop reach of a sparsely supported signal
        (the streaming layer's delta path). ``dense`` does, as in the
        reference; on the others ``GraphFilter.apply_sparse`` falls back
        to a full ``apply``.
    multi_shift : bool
        True iff the backend evaluates joint polynomials of several
        commuting shift operators (``GraphFilter.from_shifts``): ``dense``,
        ``bsr`` and ``halo``, as in the reference. ``GraphFilter`` checks
        it at dispatch, before any ``prepare``, so a backend without it
        never sees a multi-shift filter.
    """

    traceable: bool = False
    sparse_input: bool = False
    multi_shift: bool = False


@runtime_checkable
class FilterBackend(Protocol):
    """Protocol every ``GraphFilter`` backend implements.

    Attributes
    ----------
    name : str
        Registry key, e.g. ``"dense"``.
    prepare_opts : frozenset of str
        Keyword options that select which prepared state is used (part of
        the filter's state-cache key).
    capabilities : BackendCapabilities
        The backend's declared capability record.
    """

    name: str
    prepare_opts: frozenset[str]
    capabilities: BackendCapabilities

    def prepare(self, filt, **opts) -> Any:
        """Build backend state for ``filt``; cached per prepare-opts."""
        ...

    def apply(self, filt, state, f, *, coeffs=None, **opts) -> torch.Tensor:
        """``Phi~ f`` -> (eta,) + f.shape."""
        ...

    def adjoint(self, filt, state, a, **opts) -> torch.Tensor:
        """``Phi~* a`` for ``a`` shaped (eta,) + signal.shape."""
        ...

    def messages_per_apply(self, filt, state, matvec_counts: Sequence[int]) -> int:
        """Scalar words exchanged between workers per apply (0 when the
        backend runs on one device)."""
        ...


_REGISTRY: dict[str, FilterBackend] = {}


def register_backend(cls):
    """Class decorator: instantiate and register a backend under its
    ``name``. Re-registering a name overwrites."""
    backend = cls()
    if not isinstance(backend, FilterBackend):
        raise TypeError(f"{cls!r} does not implement FilterBackend")
    if not isinstance(getattr(backend, "capabilities", None), BackendCapabilities):
        raise TypeError(f"{cls!r} must declare capabilities as a BackendCapabilities instance")
    _REGISTRY[backend.name] = backend
    return cls


def get_backend(name: str) -> FilterBackend:
    """Look up a registered backend by name (KeyError lists the others)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown filter backend {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_backends() -> tuple[str, ...]:
    """Names of all registered backends, sorted."""
    return tuple(sorted(_REGISTRY))


def backend_capabilities(name: str) -> BackendCapabilities:
    """The :class:`BackendCapabilities` record of backend ``name``."""
    return get_backend(name).capabilities


def backend_is_traceable(name: str) -> bool:
    """True iff backend ``name`` declares the ``traceable`` capability."""
    return backend_capabilities(name).traceable


def backend_supports_sparse(name: str) -> bool:
    """True iff backend ``name`` declares ``sparse_input`` (implements
    ``apply_sparse``)."""
    return backend_capabilities(name).sparse_input


def backend_supports_multi_shift(name: str) -> bool:
    """True iff backend ``name`` evaluates multi-shift joint filters."""
    return backend_capabilities(name).multi_shift


def require_capability(backend: FilterBackend | str, capability: str) -> None:
    """Raise unless ``backend`` declares ``capability``; the error names
    both and the backends that do support it::

        backend 'allgather' does not support capability 'multi_shift';
        supported backends: ['bsr', 'dense', 'halo']
    """
    be = get_backend(backend) if isinstance(backend, str) else backend
    caps = be.capabilities
    if not hasattr(caps, capability):
        raise AttributeError(
            f"unknown capability {capability!r}; declared capabilities: "
            f"{[f.name for f in dataclasses.fields(caps)]}"
        )
    if not getattr(caps, capability):
        supported = sorted(
            n for n, b in _REGISTRY.items() if getattr(b.capabilities, capability, False)
        )
        raise ValueError(
            f"backend {be.name!r} does not support capability "
            f"{capability!r}; supported backends: {supported}"
        )
