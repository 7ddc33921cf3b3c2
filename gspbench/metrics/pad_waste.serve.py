"""Percent of the apply and solve lanes' panel slots that were zero
padding in the window: the engine's ``pad_slots / panel_slots``."""


def read(ctx):
    slots = ctx.counters.get("panel_slots", 0)
    if not slots:
        return None
    return 100.0 * ctx.counters["pad_slots"] / slots
