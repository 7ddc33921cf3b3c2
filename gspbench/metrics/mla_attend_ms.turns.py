"""Median, over the traced slice's decode steps, of the milliseconds the
step's latent attention took: the summed device time (host time on the
CPU) of the absorbed ``mla.attend`` spans inside each ``lm.decode_step``."""

from gspbench import spans


def _step(record):
    while record is not None and record.name != "lm.decode_step":
        record = record.parent
    return record


def read(ctx):
    per_step = {}
    for r in spans.records("mla.attend"):
        step = _step(r)
        if step is not None and r.attrs.get("mode") == "absorbed":
            per_step[id(step)] = per_step.get(id(step), 0.0) + spans.ms(r)
    return spans.median(list(per_step.values()))
