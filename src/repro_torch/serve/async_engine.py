"""``AsyncGraphFilterEngine`` — continuous-batching graph-filter serving.

Mirrors ``repro/serve/async_engine.py``. The synchronous
:class:`repro_torch.serve.GraphFilterEngine` is a micro-batcher: callers
drive ``flush()`` themselves and panels are a fixed width. This engine is
the production story:

* **Ticket API** — ``submit`` / ``submit_solve`` / ``submit_frame``
  enqueue and return a :class:`~repro_torch.serve.tickets.Ticket`
  immediately; callers never block on panel fill. ``poll`` reads a
  ticket, ``wait`` pumps the engine until it resolves.
* **Continuous batching** — a :class:`~repro_torch.serve.scheduler.Scheduler`
  forms panels from the shared queue per lane: full ``max_panel`` panels
  under load, deadline-forced partial panels when traffic is thin, under
  per-tenant admission control.
* **Program cache** — panels pack into power-of-two width buckets
  (``repro_torch.filters.bucket_size``), and one program per
  (lane, backend, N, bucket) answers every panel in that bucket:
  ``GraphFilter.panel_program`` for applies, ``lasso_panel_program`` for
  whole fixed-budget solves. On the card a program is one recorded CUDA
  graph (:class:`repro_torch.filters.CudaGraphProgram`), so
  ``engine.recompiles`` counts captures exactly — steady state is zero.
* **Bounded stream state** — per-stream ``StreamingFilter`` lanes are
  evicted LRU past ``max_streams`` and/or after ``stream_ttl_s`` idle
  seconds (``streams_evicted`` counts them); an evicted stream's next
  frame recovers with one cold full apply. ``submit_frame`` accepts a
  per-frame ``delta=`` (:class:`repro_torch.dynamic.GraphDelta`).
* **Virtual-clock mode** — every entry point takes ``now=``; when given,
  completions are stamped on a single-server virtual timeline
  (``start = max(now, busy_until)``, ``done = start + measured wall
  seconds``). On the card a panel's measured window ends when the device
  has finished its work: apply and solve panels end with the host copy of
  their answers, frame panels with an event the host waits on (their
  outputs stay on the device), so ``busy_s`` and every virtual latency
  include the device time, not only the host's queueing.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import upload
from repro_torch.filters import CudaGraphProgram, GraphFilter, backend_is_traceable, bucket_size
from repro_torch.serve.cache import CompiledPanelCache
from repro_torch.serve.engine import (
    _bind_solver_backend,
    _LassoPanelSolver,
    host_copy,
    solve_answers,
)
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig
from repro_torch.serve.tickets import LANES, Ticket
from repro_torch.solvers import LassoProblem, SolveResult, lasso_panel_program
from repro_torch.stream import StreamingFilter
from repro_torch.stream.api import stream_device
from repro_torch.telemetry import span

__all__ = ["AsyncGraphFilterEngine"]


@dataclasses.dataclass
class _SolveProgram:
    """A whole fixed-budget lasso solve per width bucket: ``program`` (a
    recorded CUDA graph on the card, the plain function on the CPU) maps
    a panel to ``(x, a, history)``, all on the device; the result carries
    the spec's metadata."""

    program: Callable
    spec: _LassoPanelSolver
    backend: str
    messages_per_iteration: int

    def __call__(self, panel: torch.Tensor) -> SolveResult:
        x, a, hist = self.program(panel)
        return SolveResult(
            x=x,
            aux=a,
            history=hist,
            iterations=self.spec.n_iters,
            converged=True,
            method=self.spec.method,
            backend=self.backend,
            messages_per_iteration=self.messages_per_iteration,
        )


class AsyncGraphFilterEngine:
    """Asynchronous continuous-batching front end for a ``GraphFilter``.

    Parameters
    ----------
    filt : GraphFilter
        The filter to serve (graph bound for graph-bound backends).
    backend : str
        ``GraphFilter`` backend answering apply panels (and, unless the
        solver names its own, solve panels).
    solver : callable, optional
        ``panel -> SolveResult`` for the solve lane — build one with
        :func:`repro_torch.serve.lasso_panel_solver`. A solver built
        without an explicit backend inherits the engine's. When the
        solver is a fixed-budget lasso spec on a traceable backend, the
        engine builds the *whole solve* as one program per width bucket
        instead of calling it eagerly.
    config : SchedulerConfig
        Batching policy: panel width cap, bucket floor, per-lane latency
        budgets, per-tenant admission quota.
    opts / stream_opts : dict
        Backend options for every apply / per-stream ``StreamingFilter``
        options, as on the synchronous engine.
    max_streams : int or None
        Cap on live per-stream lanes; the least recently used lanes past
        it are dropped (their next frame recovers with one full apply).
        None disables the cap.
    stream_ttl_s : float or None
        Idle time-to-live for stream lanes, measured on the engine clock
        (virtual ``now=`` timestamps included). None disables TTL
        eviction.
    clock : callable
        0-arg seconds source for default timestamps (injectable for
        tests; ``now=`` arguments override per call).
    device : str or torch.device, optional
        Default ``cuda`` (raises without it); must be the filter's
        graph's device. The stream lanes run on it too.
    """

    def __init__(
        self,
        filt: GraphFilter,
        *,
        backend: str = "bsr",
        solver: Callable[[Any], SolveResult] | None = None,
        config: SchedulerConfig | None = None,
        opts: dict | None = None,
        stream_opts: dict | None = None,
        max_streams: int | None = 4096,
        stream_ttl_s: float | None = None,
        clock: Callable[[], float] = time.perf_counter,
        device: str | torch.device | None = None,
    ):
        self.device = stream_device(filt, device)
        self.filt = filt
        self.backend = backend
        self.solver = _bind_solver_backend(solver, backend)
        self.config = config or SchedulerConfig()
        self.opts = dict(opts or {})
        self.stream_opts = dict(stream_opts or {})
        self.clock = clock

        self.max_streams = max_streams
        self.stream_ttl_s = stream_ttl_s

        self.scheduler = Scheduler(self.config)
        self.cache = CompiledPanelCache()
        self._tids = itertools.count()
        # Insertion order doubles as LRU order: touching a stream pops and
        # reinserts it, so the first key is always the coldest lane.
        self._streams: dict[Any, StreamingFilter] = {}
        self._stream_seen: dict[Any, float] = {}
        self._busy_until = 0.0  # virtual-clock single-server frontier

        # Accounting (mirrors the synchronous engine where lanes overlap).
        self.served = 0
        self.applies = 0
        self.solved = 0
        self.solves = 0
        self.frames_served = 0
        self.streams_evicted = 0
        self.panel_slots = 0  # bucketed slots executed (apply+solve lanes)
        self.pad_slots = 0  # of those, zero-padding waste
        self.busy_s = 0.0  # wall seconds inside panel executions

    # -- submission (never blocks) -----------------------------------------

    def submit(self, signal, *, tenant: str = "default", now: float | None = None) -> Ticket:
        """Queue one (N,) signal on the apply lane; returns its ticket."""
        return self._enqueue("apply", np.asarray(signal), tenant, now)

    def submit_solve(self, signal, *, tenant: str = "default", now: float | None = None) -> Ticket:
        """Queue one (N,) signal on the iterative-solve lane."""
        if self.solver is None:
            raise ValueError("engine has no solver=; build one with lasso_panel_solver()")
        return self._enqueue("solve", np.asarray(signal), tenant, now)

    def submit_frame(
        self,
        stream_id,
        frame,
        *,
        delta=None,
        tenant: str = "default",
        now: float | None = None,
    ) -> Ticket:
        """Queue one (N,) frame on ``stream_id``'s streaming lane.

        ``delta`` is an optional :class:`repro_torch.dynamic.GraphDelta`
        applied to the stream's shift operator before this frame. The
        engine's shared ``GraphFilter`` is never mutated; churn state
        lives entirely inside the per-stream lane.
        """
        return self._enqueue(
            "frame",
            (stream_id, np.asarray(frame), delta),
            tenant,
            now,
            stream_id=stream_id,
        )

    def _enqueue(self, lane, payload, tenant, now, stream_id=None) -> Ticket:
        t = self.clock() if now is None else now
        ticket = Ticket(
            tid=next(self._tids),
            lane=lane,
            tenant=tenant,
            t_submit=t,
            stream_id=stream_id,
        )
        self.scheduler.admit(ticket, payload)
        return ticket

    # -- the pump -----------------------------------------------------------

    def step(self, now: float | None = None) -> int:
        """Execute every panel the scheduling policy says is ready.

        Returns the number of panels executed. With ``now=`` the engine
        runs on the caller's virtual clock (completions stamped on the
        single-server timeline); without, on ``self.clock``.
        """
        virtual = now is not None
        t = self.clock() if now is None else now
        executed = 0
        for lane in LANES:
            while (batch := self.scheduler.ready(lane, t)) is not None:
                self._execute(lane, batch, t, virtual)
                executed += 1
        return executed

    def drain(self, now: float | None = None) -> int:
        """Force-flush everything pending, deadline or not."""
        virtual = now is not None
        t = self.clock() if now is None else now
        executed = 0
        for lane in LANES:
            while (batch := self.scheduler.force(lane)) is not None:
                self._execute(lane, batch, t, virtual)
                executed += 1
        return executed

    def poll(self, ticket: Ticket, *, now: float | None = None):
        """One pump, then the ticket's result — or None if still pending."""
        if not ticket.done:
            self.step(now=now)
        return ticket.result if ticket.done else None

    def wait(self, ticket: Ticket, *, now: float | None = None):
        """Pump until ``ticket`` resolves (force-flushing its lane if the
        deadline has not fired) and return its result."""
        if not ticket.done:
            self.step(now=now)
        virtual = now is not None
        t = self.clock() if now is None else now
        while not ticket.done:
            batch = self.scheduler.force(ticket.lane)
            if batch is None:  # pragma: no cover - resolve() is unconditional
                raise RuntimeError(f"ticket {ticket.tid} lost from its lane")
            self._execute(ticket.lane, batch, t, virtual)
        return ticket.result

    # -- panel execution ----------------------------------------------------

    def _execute(self, lane, batch, now: float, virtual: bool) -> None:
        with span("serve.panel") as sp:
            if sp:
                start = max(now, self._busy_until) if virtual else self.clock()
                sp.note(lane=lane, k=len(batch), tids=[req.ticket.tid for req in batch],
                        queue_wait_s=[start - req.ticket.t_submit for req in batch])
            t0 = time.perf_counter()
            results = self._run_panel(lane, batch, now)
            if lane == "frame" and self.device.type == "cuda":
                # Frame outputs stay on the device: end the timed window when
                # the device has finished the panel's work.
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                done.synchronize()
            dt = time.perf_counter() - t0
            self.busy_s += dt
            if virtual:
                start = max(now, self._busy_until)
                t_done = start + dt
                self._busy_until = t_done
            else:
                t_done = self.clock()
            with span("serve.resolve"):
                for req, res in zip(batch, results):
                    req.ticket._resolve(res, t_done)
                    self.scheduler.release(req.ticket)

    def _run_panel(self, lane, batch, now: float) -> list:
        if lane == "apply":
            return self._run_apply(batch)
        if lane == "solve":
            return self._run_solve(batch)
        return self._run_frames(batch, now)

    def _pack(self, batch) -> tuple[np.ndarray, int, int]:
        """Stack (N,) payloads into a bucket-width zero-padded panel."""
        with span("serve.pack") as sp:
            k = len(batch)
            panel = np.stack([req.payload for req in batch], axis=1)
            if panel.dtype != np.float32:
                panel = panel.astype(np.float32)
            b = bucket_size(k, self.config.max_panel, floor=self.config.min_bucket)
            if k < b:
                panel = np.pad(panel, ((0, 0), (0, b - k)))
            if sp:
                sp.note(b=b, k=k)
        self.panel_slots += b
        self.pad_slots += b - k
        return panel, k, b

    def _run_program(self, key, build, panel: np.ndarray):
        """Upload ``panel`` and run the cached program under ``key`` on it:
        a replay, or on a cache miss the program's build and first call
        (on the card, the capture of its CUDA graph)."""
        with span("serve.upload") as sp:
            if sp:
                sp.note(bytes=panel.nbytes)
            dev_panel = upload(panel, self.device)
        with span("serve.replay" if key in self.cache else "serve.capture") as sp:
            if sp:
                sp.note(lane=key[0], b=key[-1])
            return self.cache.get(key, build)(dev_panel)

    def _run_apply(self, batch) -> list[torch.Tensor]:
        panel, k, b = self._pack(batch)
        out = self._run_program(
            ("apply", self.backend, panel.shape[0], b),
            # The engine copies the answers to the host at once and never
            # keeps the program's output, so the program may return its
            # static output buffer (donate=True): no net device
            # allocation per batch at steady state.
            lambda: self.filt.panel_program(backend=self.backend, donate=True, **self.opts),
            panel,
        )
        with span("serve.copy_back"):
            (out,) = host_copy(out)  # (eta, N, b)
            answers = [out[:, :, i] for i in range(k)]
        self.applies += 1
        self.served += k
        return answers

    def _run_solve(self, batch) -> list[SolveResult]:
        panel, k, b = self._pack(batch)
        solve_backend = getattr(self.solver, "backend", None) or self.backend
        res = self._run_program(
            ("solve", solve_backend, panel.shape[0], b),
            lambda: self._build_solve_program(panel.shape[0]),
            panel,
        )
        with span("serve.copy_back"):
            answers = solve_answers(res, k)
        self.solves += 1
        self.solved += k
        return answers

    def _build_solve_program(self, n: int):
        """Build the whole solve as one program when the spec allows, else
        pass the solver through.

        A :func:`repro_torch.serve.lasso_panel_solver` spec with a fixed
        budget (``tol=None``) on a traceable backend becomes one
        ``lasso_panel_program`` per width bucket, recorded as a CUDA graph
        on the card (with no early exit it runs no host synchronisation);
        anything else (custom callables, tolerance-mode solves, host-loop
        backends) is served eagerly — still shape-stable thanks to the
        bucketed pack.
        """
        spec = self.solver
        if not (
            isinstance(spec, _LassoPanelSolver)
            and spec.tol is None
            and backend_is_traceable(spec.backend or "bsr")
        ):
            return spec
        be = spec.backend or "bsr"
        run = lasso_panel_program(
            spec.filt,
            method=spec.method,
            mu=spec.mu,
            step=spec.step,
            n_iters=spec.n_iters,
            backend=be,
            **spec.opts,
        )
        g = spec.filt.graph
        if g is not None and g.device.type == "cuda":
            # Same donation discipline as the apply lane.
            run = CudaGraphProgram(run, g.device, donate=True)
        problem = LassoProblem(filt=spec.filt, y=np.zeros((n,), np.float32), mu=spec.mu)
        return _SolveProgram(
            program=run,
            spec=spec,
            backend=be,
            messages_per_iteration=problem.messages_per_iteration(be, **spec.opts),
        )

    def _run_frames(self, batch, now: float) -> list:
        results = []
        for req in batch:
            stream_id, frame, gdelta = req.payload
            lane = self._streams.pop(stream_id, None)
            if lane is None:
                lane = StreamingFilter(
                    self.filt,
                    backend=self.backend,
                    opts=self.opts,
                    device=self.device,
                    **self.stream_opts,
                )
            else:
                self._stream_seen.pop(stream_id, None)
            # Reinsert at the tail: dict order is the LRU order.
            self._streams[stream_id] = lane
            self._stream_seen[stream_id] = now
            with span("serve.frame") as sp:
                res = lane.push(frame, delta=gdelta)
                if sp:
                    sp.note(tid=req.ticket.tid, stream=stream_id, mode=res.mode)
            results.append(res)
            self.frames_served += 1
        self._evict_streams(now)
        return results

    def _evict_streams(self, now: float) -> None:
        """Drop idle stream lanes: TTL pass first, then the LRU cap.

        An evicted stream is not an error — its next frame is served as a
        cold full apply by a fresh lane. This bounds resident per-stream
        state (output panels, churn Krylov stacks) under a 100k-stream
        load, where most streams go quiet forever.
        """
        if self.stream_ttl_s is not None:
            expired = [s for s, t in self._stream_seen.items() if now - t > self.stream_ttl_s]
            for s in expired:
                del self._streams[s]
                del self._stream_seen[s]
                self.streams_evicted += 1
        if self.max_streams is not None:
            while len(self._streams) > self.max_streams:
                s = next(iter(self._streams))  # coldest lane
                del self._streams[s]
                del self._stream_seen[s]
                self.streams_evicted += 1

    # -- observability -------------------------------------------------------

    @property
    def busy_until(self) -> float:
        """The virtual clock's frontier: when the last panel executed on
        the virtual timeline finished (0.0 before any)."""
        return self._busy_until

    def reset_clock(self) -> None:
        """Start a fresh virtual timeline (a load generator replaying a
        trace from t = 0 again); counters and programs are kept."""
        self._busy_until = 0.0

    @property
    def recompiles(self) -> int:
        """Program builds so far (cache misses; 0 in steady state). On the
        card each is one CUDA graph capture."""
        return self.cache.misses

    @property
    def pad_waste(self) -> float:
        """Fraction of executed panel slots that were zero padding."""
        return self.pad_slots / max(self.panel_slots, 1)

    def stats(self) -> dict:
        """Counters snapshot for a load generator. ``captures`` and
        ``replays`` sum the recorded CUDA graph programs' counters (0 on
        the CPU)."""
        programs = (getattr(p, "program", p) for p in self.cache.programs().values())
        recorded = [p for p in programs if isinstance(p, CudaGraphProgram)]
        return {
            "served": self.served,
            "applies": self.applies,
            "solved": self.solved,
            "solves": self.solves,
            "frames_served": self.frames_served,
            "streams": len(self._streams),
            "streams_evicted": self.streams_evicted,
            "pending": self.scheduler.pending(),
            "admitted": self.scheduler.admitted,
            "rejected": self.scheduler.rejected,
            "busy_s": self.busy_s,
            "pad_waste": self.pad_waste,
            "recompiles": self.recompiles,
            "captures": sum(p.captures for p in recorded),
            "replays": sum(p.replays for p in recorded),
            **{f"cache_{k}": v for k, v in self.cache.stats().items()},
        }
