"""Continuous-batching scheduler: shared request queue, panel forming,
per-tenant admission control, per-lane latency budgets.

Mirrors ``repro/serve/scheduler.py`` (pure host code, as it is there).

Policy (DESIGN.md Sec. 9): requests from all callers land in one shared
queue, partitioned by lane (applies / solves / frames keep distinct
compiled programs, so a panel is always single-lane). A lane's panel is
*ready* when either

* ``max_panel`` requests are pending (a full panel — the throughput
  case), or
* the lane's oldest request has waited ``latency_budget_s`` (the tail-
  latency case: a partial panel ships rather than stalling its callers).

Admission control is a per-tenant in-flight cap: a tenant with
``max_pending_per_tenant`` unresolved requests gets
:class:`AdmissionError` instead of unbounded queue growth — one hot
tenant cannot starve the rest of the fleet's latency budget.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

from repro_torch.serve.tickets import LANES, Ticket

__all__ = ["AdmissionError", "SchedulerConfig", "Scheduler"]


class AdmissionError(RuntimeError):
    """Raised by ``submit_*`` when a tenant exceeds its in-flight quota."""


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Scheduling policy knobs.

    Parameters
    ----------
    max_panel : int
        Widest panel the scheduler forms (and the cap passed to
        ``bucket_size`` — the largest compiled program).
    min_bucket : int
        Smallest panel bucket; partial panels pad up to at least this.
    latency_budget_s : float
        Default per-lane deadline: a partial panel ships once its oldest
        request has waited this long.
    lane_budget_s : mapping, optional
        Per-lane overrides of ``latency_budget_s`` (e.g. a looser budget
        for the solve lane, whose panels are far more expensive).
    max_pending_per_tenant : int
        Admission cap on a tenant's unresolved requests.
    """

    max_panel: int = 128
    min_bucket: int = 8
    latency_budget_s: float = 0.05
    lane_budget_s: dict[str, float] | None = None
    max_pending_per_tenant: int = 4096

    def budget(self, lane: str) -> float:
        """The deadline for ``lane`` (override or default)."""
        if self.lane_budget_s and lane in self.lane_budget_s:
            return self.lane_budget_s[lane]
        return self.latency_budget_s


@dataclasses.dataclass
class _Request:
    ticket: Ticket
    payload: Any


class Scheduler:
    """FIFO queues per lane + the panel-forming policy above."""

    def __init__(self, config: SchedulerConfig):
        if config.max_panel < 1:
            raise ValueError(f"max_panel must be >= 1, got {config.max_panel}")
        self.config = config
        self._queues: dict[str, collections.deque[_Request]] = {
            lane: collections.deque() for lane in LANES
        }
        self._in_flight: collections.Counter[str] = collections.Counter()
        self.admitted = 0
        self.rejected = 0

    # -- intake ------------------------------------------------------------

    def admit(self, ticket: Ticket, payload: Any) -> None:
        """Enqueue one request, or raise :class:`AdmissionError`."""
        cap = self.config.max_pending_per_tenant
        if self._in_flight[ticket.tenant] >= cap:
            self.rejected += 1
            raise AdmissionError(
                f"tenant {ticket.tenant!r} has {cap} requests in flight "
                "(max_pending_per_tenant); poll/wait before submitting more"
            )
        self._queues[ticket.lane].append(_Request(ticket, payload))
        self._in_flight[ticket.tenant] += 1
        self.admitted += 1

    def release(self, ticket: Ticket) -> None:
        """Return a resolved ticket's admission slot to its tenant."""
        self._in_flight[ticket.tenant] -= 1

    # -- panel forming -----------------------------------------------------

    def pending(self, lane: str | None = None) -> int:
        """Queued (not yet executed) requests, in one lane or all."""
        if lane is not None:
            return len(self._queues[lane])
        return sum(len(q) for q in self._queues.values())

    def oldest_deadline(self, lane: str) -> float | None:
        """Clock time at which ``lane``'s head request must ship."""
        q = self._queues[lane]
        if not q:
            return None
        return q[0].ticket.t_submit + self.config.budget(lane)

    def ready(self, lane: str, now: float) -> list[_Request] | None:
        """Dequeue one panel if the lane's policy fires, else None."""
        q = self._queues[lane]
        if not q:
            return None
        if len(q) < self.config.max_panel and now < self.oldest_deadline(lane):
            return None
        return self._take(lane)

    def force(self, lane: str) -> list[_Request] | None:
        """Dequeue one panel regardless of deadline (drain path)."""
        if not self._queues[lane]:
            return None
        return self._take(lane)

    def _take(self, lane: str) -> list[_Request]:
        q = self._queues[lane]
        return [q.popleft() for _ in range(min(len(q), self.config.max_panel))]
