"""The program's own spans (``repro_torch.telemetry``) as the per-layer
metrics read them.

The run's first telemetry session is the traced slice of the window: the
tracer's warm-up session runs no program call, and the readers that profile
calls of their own run after the window. Where the program has no recorder
(an older program) or recorded nothing, every reader gets nothing to read.
"""

from __future__ import annotations

import statistics

__all__ = ["first_session", "records", "ms", "self_ms", "median", "mean"]


def first_session():
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    found = telemetry.sessions()
    return found[0] if found else None


def records(name: str) -> list:
    """The first session's records of the span ``name``."""
    session = first_session()
    return session.named(name) if session is not None else []


def ms(record) -> float:
    """A span's device milliseconds (its CUDA events), where it has them;
    else its host milliseconds."""
    device = record.device_ms()
    return record.host_ms if device is None else device


def self_ms(name: str, minus: tuple[str, ...]) -> list[float]:
    """For each ``name`` span of the first session, its time (``ms``) less
    that of its direct children named in ``minus``."""
    session = first_session()
    if session is None:
        return []
    inner: dict[int, float] = {}
    for r in session.records:
        if r.name in minus and r.parent is not None:
            inner[id(r.parent)] = inner.get(id(r.parent), 0.0) + ms(r)
    return [ms(r) - inner.get(id(r), 0.0) for r in session.named(name)]


def median(values):
    return statistics.median(values) if values else None


def mean(values):
    return statistics.fmean(values) if values else None
