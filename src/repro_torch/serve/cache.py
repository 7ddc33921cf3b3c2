"""Compiled-program cache for the serving engine's panel lanes.

Mirrors ``repro/serve/cache.py``. The cache's keys are the power-of-two
shape buckets the scheduler packs panels into
(``repro_torch.filters.bucket_size``), so a workload with wobbling panel
widths settles onto a logarithmic number of programs: every bucket is
built exactly once (its cache *miss*), and steady-state traffic is all
*hits* — the recompile counter the acceptance tests read is simply
``misses``.

What a "program" is in torch: on the card, a
:class:`repro_torch.filters.CudaGraphProgram` — one recorded CUDA graph
of the whole apply (or whole fixed-budget solve) per bucket, so one miss
is one capture; on the CPU, the prepared closure. Programs are built with
``donate=True``: the engine never keeps a program's output (it copies
each panel's answers to the host at once), so the program may hand back
its static output buffer and a lane allocates no net device memory per
batch at steady state.
"""

from __future__ import annotations

import types
from typing import Any, Callable, Hashable, Mapping

__all__ = ["CompiledPanelCache"]


class CompiledPanelCache:
    """Build-once dictionary of compiled panel programs with hit/miss
    counters.

    A "program" is whatever ``build`` returns — a recorded CUDA graph
    program for traceable backends on the card, a plain callable
    otherwise; the cache only guarantees ``build`` runs once per key.
    Because every cached program is fed exactly one input shape (its
    bucket), one miss corresponds to one capture on the card: ``misses``
    IS the recompile count.
    """

    def __init__(self) -> None:
        self._programs: dict[Hashable, Any] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the program under ``key``, building it on first use."""
        try:
            prog = self._programs[key]
        except KeyError:
            prog = self._programs[key] = build()
            self.misses += 1
        else:
            self.hits += 1
        return prog

    def programs(self) -> Mapping[Hashable, Any]:
        """A read-only view of the built programs, by key."""
        return types.MappingProxyType(self._programs)

    def __len__(self) -> int:
        return len(self._programs)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._programs

    @property
    def recompiles(self) -> int:
        """Alias for ``misses`` — each miss is one program build/capture."""
        return self.misses

    def stats(self) -> dict[str, int]:
        """Counters snapshot: ``programs`` / ``hits`` / ``misses``."""
        return {
            "programs": len(self._programs),
            "hits": self.hits,
            "misses": self.misses,
        }
