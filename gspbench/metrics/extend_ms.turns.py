"""Median milliseconds of one extension of every session by its question:
the ``lm.extend`` spans' device time (their CUDA events; host time on the
CPU) in the traced slice."""

from gspbench import spans


def read(ctx):
    return spans.median([spans.ms(r) for r in spans.records("lm.extend")])
