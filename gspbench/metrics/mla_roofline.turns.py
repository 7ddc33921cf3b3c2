"""Percent of its bound that one absorbed latent-attention call reaches at
the cell's first decode step: the least time of the work the call needs
(``work_lm.absorbed_mla_work`` from the cell's shapes) over the summed
device time of every kernel inside one call (5 calls profiled)."""

from gspbench import work_lm


def read(ctx):
    call = ctx.operands.get("mla_call")
    if call is None:
        return None
    device_s = ctx.device_seconds_per_call(call)
    if not device_s:
        return None
    bound_s, _ = work_lm.bound_seconds(*work_lm.absorbed_mla_work(**ctx.operands["mla_shape"]))
    return 100.0 * bound_s / device_s
