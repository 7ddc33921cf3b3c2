"""Milliseconds of one ``GraphFilter.adjoint`` on the backend, on the last
solve's own coefficients: the median of CUDA-event times over 5 calls
after one."""


def read(ctx):
    a = ctx.operands.get("coeffs")
    if a is None:
        return None
    return 1e3 * ctx.event_seconds(lambda: ctx.prog.adjoint(a))
