"""Median milliseconds of one ``GraphFilter.adjoint`` inside the solves of
the traced slice: device time between each ``filter.adjoint`` span's CUDA
events (host time on the CPU)."""

from gspbench import spans


def read(ctx):
    return spans.median([spans.ms(r) for r in spans.records("filter.adjoint")])
