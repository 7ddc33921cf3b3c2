"""Roofline terms from per-device analysis numbers, against an H100 model.

Mirrors ``repro/launch/hlo_analysis.py``. The reference reads FLOPs and
bytes from XLA's compiled, SPMD-partitioned HLO and parses collectives
from its text (``parse_collective_bytes``, ``count_hlo_ops``). The port
has no HLO: its numbers come from an aten op trace of the port's own step
on ``meta`` tensors (``launch.op_costs``) and a stated model of the
collectives (``launch.comm``), and :func:`count_ops` counts opcodes in the
trace's op histogram in place of the two HLO text parsers.

Hardware model (one H100 SXM, NVIDIA's data sheet, dense rates at the
700 W limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, 80 GB.
Collectives over a 16-wide mesh axis leave a DGX node's 8-card NVLink
domain, so ``link_bw`` is one card's NDR InfiniBand port, 400 Gb/s = 50
GB/s; ``nvlink_bw`` (450 GB/s per direction) is kept for the record.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["HW", "Hardware", "roofline_terms", "count_ops", "model_flops_train",
           "model_flops_infer"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 989e12       # bf16 FLOP/s per card (chip_smoke.BF16_FLOPS_PER_S)
    hbm_bw: float = 3.35e12          # bytes/s per card
    link_bw: float = 50e9            # bytes/s per card out of its node (InfiniBand NDR)
    nvlink_bw: float = 450e9         # bytes/s per card per direction inside a node
    hbm_capacity: float = 80e9       # bytes per card


HW = Hardware()


def count_ops(costs, opcodes: tuple[str, ...]) -> dict[str, int]:
    """Occurrences of each opcode in ``costs.op_counts`` (a
    ``launch.op_costs.WeightedCosts``), trip-count weighted: an entry
    ``k`` counts every aten op named ``k`` or ``k.<overload>`` (``"mm"``
    counts ``mm.default``). The counterpart of the reference's
    ``count_hlo_ops``, which scans HLO text; there is none here."""
    counts = {k: 0 for k in opcodes}
    for name, n in costs.op_counts.items():
        for k in opcodes:
            if name == k or name.startswith(k + "."):
                counts[k] += int(round(n))
    return counts


def roofline_terms(
    flops: float,
    bytes_acc: float,
    collective: Mapping[str, float],
    *,
    n_chips: int,
    hw: Hardware = HW,
    model_flops: float | None = None,
) -> dict:
    """Three roofline terms (seconds) from per-device analysis numbers.

    All inputs are per-device, i.e. FLOPs_total = flops * n_chips, so
    compute = FLOPs_total / (chips * peak) = flops / peak, etc.
    """
    coll_bytes = float(sum(collective.values()))
    compute_s = flops / hw.peak_flops
    memory_s = bytes_acc / hw.hbm_bw
    collective_s = coll_bytes / hw.link_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll_bytes,
        "bottleneck": max(
            (("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)), key=lambda kv: kv[1])[0],
    }
    if model_flops is not None:
        total = flops * n_chips
        terms["model_flops"] = model_flops
        terms["useful_flop_ratio"] = model_flops / total if total else 0.0
        bound_s = max(compute_s, memory_s, collective_s)
        ideal_s = model_flops / (n_chips * hw.peak_flops)
        terms["roofline_fraction"] = ideal_s / bound_s if bound_s else 0.0
    return terms


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """MODEL_FLOPS = 6 N D (fwd+bwd) for dense; pass active params for MoE."""
    return 6.0 * n_params_active * tokens


def model_flops_infer(n_params_active: float, tokens: float) -> float:
    """Forward-only: 2 N D."""
    return 2.0 * n_params_active * tokens
