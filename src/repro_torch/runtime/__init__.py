"""Fault-tolerance runtime of the port (mirrors ``repro/runtime``)."""

from repro_torch.runtime.fault import (
    FailureInjector,
    StragglerInjector,
    StragglerMonitor,
    WorkerFailure,
    run_with_restarts,
)

__all__ = ["FailureInjector", "StragglerInjector", "StragglerMonitor", "WorkerFailure",
           "run_with_restarts"]
