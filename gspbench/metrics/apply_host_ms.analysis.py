"""Median host milliseconds of one ``GraphFilter.apply`` in the traced
slice: what the host spends to enqueue an apply (permute, pad, tiling,
launch, unpermute), from its ``filter.apply`` spans."""

from gspbench import spans


def read(ctx):
    return spans.median([r.host_ms for r in spans.records("filter.apply")])
