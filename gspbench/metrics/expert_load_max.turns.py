"""How unevenly the router loads the experts in decode: for each MoE call
inside a traced ``lm.decode_step``, the busiest expert's tokens over the
mean per expert (the ``moe.expert_tokens`` counter); a step's value is the
mean over its MoE layers, and the metric the median over steps."""

import statistics

from gspbench import spans


def _step(record):
    while record is not None and record.name != "lm.decode_step":
        record = record.parent
    return record


def read(ctx):
    per_step = {}
    for r in spans.records("moe.expert_tokens"):
        step = _step(r)
        if step is None:
            continue
        counts = r.attrs["value"].float()
        per_step.setdefault(id(step), []).append(float(counts.max() / counts.mean()))
    return spans.median([statistics.fmean(v) for v in per_step.values()])
