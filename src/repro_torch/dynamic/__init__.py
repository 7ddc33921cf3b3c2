"""repro_torch.dynamic — topology churn: incremental Laplacians, plan
repair and mobile-sensor workloads (mirrors ``repro/dynamic``, DESIGN.md
Sec. 10).

``GraphDelta`` describes a change, ``LmaxTracker`` keeps the Chebyshev
domain certified without re-estimating ``lambda_max`` per frame, the
churn kernels correct filter outputs on the M-hop neighbourhood of the
changed edges (on the signal's device), and
``repro_torch.core.distributed.repair_partition_plan`` patches only the
partitions a delta touches. ``mobile_sensor_scenario`` generates the
random-waypoint / convoy workloads that exercise all of it.
"""

from repro_torch.dynamic.delta import (
    GraphDelta,
    LmaxTracker,
    apply_delta_inplace,
    apply_graph_delta,
    churn_correction,
    dense_cheb_apply_krylov,
    kernel_trace_counts,
    restricted_cheb_apply_krylov,
)
from repro_torch.dynamic.scenarios import (
    MobileSensorScenario,
    ScenarioFrame,
    mobile_sensor_scenario,
)

__all__ = [
    "GraphDelta",
    "LmaxTracker",
    "apply_delta_inplace",
    "apply_graph_delta",
    "churn_correction",
    "dense_cheb_apply_krylov",
    "kernel_trace_counts",
    "restricted_cheb_apply_krylov",
    "MobileSensorScenario",
    "ScenarioFrame",
    "mobile_sensor_scenario",
]
