"""Streaming graph-signal subsystem of the port (mirrors ``repro/stream``,
DESIGN.md Sec. 8).

Consecutive frames of a slowly varying scene differ on few vertices, and
every shipped operation is linear in the signal, so work amortizes across
frames:

* :class:`StreamingFilter` — carries ``(last input, last output)`` across
  frames on the device and filters only the *delta* when few vertices
  changed (the M-hop neighbourhood of the changed set), and corrects its
  output incrementally under topology churn (``push(frame, delta=)``).
* :class:`StreamingLasso` / :class:`StreamingWiener` (and
  :func:`stream_ista` / :func:`stream_fista` / :func:`stream_wiener`) —
  warm-started iterative solvers.
"""

from repro_torch.stream.api import FrameResult, StreamingFilter
from repro_torch.stream.solvers import (
    StreamingLasso,
    StreamingWiener,
    stream_fista,
    stream_ista,
    stream_wiener,
)

__all__ = [
    "FrameResult",
    "StreamingFilter",
    "StreamingLasso",
    "StreamingWiener",
    "stream_fista",
    "stream_ista",
    "stream_wiener",
]
