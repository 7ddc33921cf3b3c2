"""Percent of the traced slice of the window in which no device operation
ran (``torch.profiler``'s busy union)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.idle_share
