"""Tickets — the async engine's request/response correlation objects.

Mirrors ``repro/serve/tickets.py`` (pure host code, as it is there).

``AsyncGraphFilterEngine.submit_*`` enqueues work and returns a
:class:`Ticket` immediately (callers never block on panel fill). The
scheduler fills the ticket in place when its panel executes; ``poll``
reads it, ``wait`` pumps the engine until it resolves. Tickets carry the
submission/completion timestamps the latency accounting (and the load
generator's virtual clock) read back.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["LANES", "Ticket"]

#: The engine's three request lanes: panel applies, panel solves, and
#: per-stream frames (DESIGN.md Secs. 7.4/8/9).
LANES = ("apply", "solve", "frame")


@dataclasses.dataclass
class Ticket:
    """One queued request; resolved in place by the scheduler.

    Attributes
    ----------
    tid : int
        Engine-unique id, in global submission order.
    lane : str
        One of :data:`LANES`.
    tenant : str
        Admission-control bucket this request was accounted against.
    t_submit : float
        Clock reading at submission (the engine's injected clock — wall
        seconds by default, virtual seconds under the load generator).
    stream_id : Any
        Stream key for frame-lane tickets, else None.
    result : Any
        The per-request answer once ``done``: an (eta, N) CPU tensor for
        applies, a :class:`repro_torch.solvers.SolveResult` (CPU ``x`` and
        ``aux``) for solves, a :class:`repro_torch.stream.FrameResult`
        (``out`` on the device) for frames.
    done : bool
        True once the scheduler filled ``result``/``t_done``.
    t_done : float, optional
        Clock reading at completion.
    """

    tid: int
    lane: str
    tenant: str
    t_submit: float
    stream_id: Any = None
    result: Any = None
    done: bool = False
    t_done: float | None = None

    @property
    def latency_s(self) -> float | None:
        """Submit-to-completion seconds (None while pending)."""
        if not self.done or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def _resolve(self, result: Any, t_done: float) -> None:
        self.result = result
        self.t_done = t_done
        self.done = True
