"""Milliseconds per panel: the engine's ``busy_s`` over the panels it
executed in the window (its own counters)."""


def read(ctx):
    panels = ctx.counters.get("panels", 0)
    if not panels:
        return None
    return 1e3 * ctx.counters["busy_s"] / panels
