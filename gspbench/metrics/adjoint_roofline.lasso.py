"""Percent of its bound that one adjoint reaches: the least time of the
work the adjoint needs (``work.adjoint_work`` from the graph's nonzeros and
the solve's shapes) over the device time of every kernel inside one
``GraphFilter.adjoint`` on the last solve's coefficients."""


def read(ctx):
    a = ctx.operands.get("coeffs")
    if a is None:
        return None
    device_s = ctx.device_seconds_per_call(lambda: ctx.prog.adjoint(a))
    if not device_s:
        return None
    eta, n, f = a.shape
    bound_s, _ = ctx.work.bound_seconds(*ctx.work.adjoint_work(ctx.nnz, n, f, eta, ctx.prog.order))
    return 100.0 * bound_s / device_s
