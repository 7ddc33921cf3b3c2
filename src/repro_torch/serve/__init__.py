"""Serving layer of the port: batched engines over ``GraphFilter``.

Mirrors ``repro/serve``:

* :class:`GraphFilterEngine` — synchronous micro-batcher (fixed panel
  width, caller-driven flushes, eager applies).
* :class:`AsyncGraphFilterEngine` — continuous batching: ticket-based
  ``submit_*``/``poll``/``wait``, deadline-or-full panel forming across
  the apply/solve/frame lanes, per-tenant admission control, and a
  program cache keyed by power-of-two width buckets (one recorded CUDA
  graph per bucket on the card).

Not ported yet: ``ServeEngine``, ``make_decode_step`` and
``make_prefill``, which serve the language models of ``repro.models``
and wait for that package's port.
"""

from repro_torch.serve.async_engine import AsyncGraphFilterEngine
from repro_torch.serve.cache import CompiledPanelCache
from repro_torch.serve.engine import GraphFilterEngine, lasso_panel_solver
from repro_torch.serve.scheduler import AdmissionError, Scheduler, SchedulerConfig
from repro_torch.serve.tickets import LANES, Ticket

__all__ = [
    "AdmissionError",
    "AsyncGraphFilterEngine",
    "CompiledPanelCache",
    "GraphFilterEngine",
    "LANES",
    "Scheduler",
    "SchedulerConfig",
    "Ticket",
    "lasso_panel_solver",
]
