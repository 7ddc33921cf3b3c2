"""Serving layer of the port: batched engines over ``GraphFilter`` and
the language models.

Mirrors ``repro/serve``:

* :class:`ServeEngine` — LM prefill + decode with per-request stop
  handling (``make_prefill`` / ``make_decode_step`` build its steps).
* :class:`GraphFilterEngine` — synchronous micro-batcher (fixed panel
  width, caller-driven flushes, eager applies).
* :class:`AsyncGraphFilterEngine` — continuous batching: ticket-based
  ``submit_*``/``poll``/``wait``, deadline-or-full panel forming across
  the apply/solve/frame lanes, per-tenant admission control, and a
  program cache keyed by power-of-two width buckets (one recorded CUDA
  graph per bucket on the card).
"""

from repro_torch.serve.async_engine import AsyncGraphFilterEngine
from repro_torch.serve.cache import CompiledPanelCache
from repro_torch.serve.engine import (
    GraphFilterEngine,
    ServeEngine,
    lasso_panel_solver,
    make_decode_step,
    make_prefill,
)
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
    "ServeEngine",
    "Ticket",
    "lasso_panel_solver",
    "make_decode_step",
    "make_prefill",
]
