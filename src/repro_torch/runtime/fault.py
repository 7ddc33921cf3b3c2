"""Fault-tolerance runtime: restart-from-checkpoint orchestration,
failure injection for tests, and straggler detection and injection.

Mirrors ``repro/runtime/fault.py``; all of it is host code. Hard
failures are handled by checkpoint and restart (``run_with_restarts``
reloads the latest checkpoint and resumes at its step); stragglers are
detected here (``StragglerMonitor``) and emulated for the gossip schedules
(``StragglerInjector``, the hook of
``core.gossip.chebyshev_gossip_mean(round_delay=)``).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Iterable

__all__ = ["WorkerFailure", "FailureInjector", "run_with_restarts",
           "StragglerMonitor", "StragglerInjector"]


class WorkerFailure(RuntimeError):
    """Simulated node loss (in production: raised by the heartbeat
    watchdog when a worker misses its deadline)."""


@dataclasses.dataclass
class FailureInjector:
    """Raises WorkerFailure the first time each listed step is reached."""

    fail_at_steps: Iterable[int]

    def __post_init__(self):
        self._pending = set(self.fail_at_steps)

    def __call__(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            raise WorkerFailure(f"injected node loss at step {step}")


def run_with_restarts(
    make_trainer: Callable[[int], Any],
    n_steps: int,
    latest_step_fn: Callable[[], int | None],
    max_restarts: int = 8,
) -> dict:
    """Supervisor: (re)build the trainer from the latest checkpoint and run
    until ``n_steps`` completes or the restart budget is exhausted.

    ``make_trainer(start_step)`` restores its state for ``start_step`` (0
    = fresh init) and returns an object whose ``run(n_steps,
    start_step=)`` returns a result dict; ``restarts`` is added to it.
    """
    restarts = 0
    while True:
        start = latest_step_fn() or 0
        trainer = make_trainer(start)
        try:
            result = trainer.run(n_steps, start_step=start)
            result["restarts"] = restarts
            return result
        except WorkerFailure:
            restarts += 1
            if restarts > max_restarts:
                raise


@dataclasses.dataclass
class StragglerInjector:
    """Injects per-rank interconnect delay into collective rounds.

    ``alpha_ms``      — per-message launch latency; a gossip round sending
                        ``n_messages`` neighbour messages from one rank
                        pays ``alpha_ms * n_messages``.
    ``rank_delay_ms`` — extra per-round delay for specific ranks: the
                        straggler.

    The reference's hooks run on concurrent device threads, so their
    sleeps overlap like wire latency on independent links. The port calls
    them on the host once per local rank in turn, so on a ``StackedMesh``
    the sleeps add up: read ``rounds_injected`` and the configured
    milliseconds, not wall time.
    """

    alpha_ms: float = 0.0
    rank_delay_ms: dict[int, float] | None = None

    def __post_init__(self):
        if self.rank_delay_ms is None:
            self.rank_delay_ms = {}
        self.rounds_injected = 0

    def _rank_ms(self, rank: int) -> float:
        return self.rank_delay_ms.get(int(rank), 0.0)

    def gossip_round(self, rank: int, round_k: int, n_messages: int) -> None:
        """Per-round hook: message launch latency + this rank's slowness."""
        del round_k
        ms = self.alpha_ms * n_messages + self._rank_ms(rank)
        self.rounds_injected += 1
        if ms > 0.0:
            time.sleep(ms / 1e3)

    def allreduce_barrier(self, rank: int, n_phases: int) -> None:
        """Per-step hook for the ring all-reduce reference: the straggler
        is late on each of the ``n_phases`` sequential phases, and the
        barrier makes everyone inherit the sum."""
        ms = (self.alpha_ms + self._rank_ms(rank)) * n_phases
        self.rounds_injected += 1
        if ms > 0.0:
            time.sleep(ms / 1e3)


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the median step time of a
    sliding window (from the ninth step on), on ``time.monotonic``."""

    window: int = 32
    threshold: float = 2.0

    def __post_init__(self):
        self._times: list[float] = []
        self._last: float | None = None
        self.flagged: list[int] = []

    def tick(self, step: int) -> bool:
        now = time.monotonic()
        slow = False
        if self._last is not None:
            dt = now - self._last
            if len(self._times) >= 8:
                med = statistics.median(self._times[-self.window:])
                if dt > self.threshold * med:
                    self.flagged.append(step)
                    slow = True
            self._times.append(dt)
        self._last = now
        return slow
