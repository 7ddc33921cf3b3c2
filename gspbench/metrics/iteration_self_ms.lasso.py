"""Median milliseconds per FISTA iteration outside its filter apply and
adjoint: each ``solver.iteration`` span's device time (its CUDA events;
host time on the CPU) less that of its ``filter.apply`` and
``filter.adjoint`` children, i.e. the prox, the momentum and the
objective."""

from gspbench import spans


def read(ctx):
    return spans.median(spans.self_ms("solver.iteration", ("filter.apply", "filter.adjoint")))
