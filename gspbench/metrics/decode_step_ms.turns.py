"""Median milliseconds of one decode step of every session's answer: the
``lm.decode_step`` spans' device time (their CUDA events; host time on
the CPU) in the traced slice."""

from gspbench import spans


def read(ctx):
    return spans.median([spans.ms(r) for r in spans.records("lm.decode_step")])
