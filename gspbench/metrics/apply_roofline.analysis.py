"""Percent of its bound that one apply reaches: the least time of the work
the apply needs (``work.apply_work`` from the graph's nonzeros and the
panel's shape) over the device time of every kernel inside one
``GraphFilter.apply`` on a pool panel."""


def read(ctx):
    panel = ctx.operands.get("panel")
    if panel is None:
        return None
    device_s = ctx.device_seconds_per_call(lambda: ctx.prog.apply(panel))
    if not device_s:
        return None
    n, f = panel.shape
    work = ctx.work.apply_work(ctx.nnz, n, f, ctx.prog.eta, ctx.prog.order)
    bound_s, _ = ctx.work.bound_seconds(*work)
    return 100.0 * bound_s / device_s
