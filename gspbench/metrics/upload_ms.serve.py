"""Mean host milliseconds per apply or solve panel of its upload to the
card through pinned memory (the ``serve.upload`` spans of the traced
slice)."""

from gspbench import spans


def read(ctx):
    return spans.mean([r.host_ms for r in spans.records("serve.upload")])
