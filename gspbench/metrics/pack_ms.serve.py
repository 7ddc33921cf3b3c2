"""Mean host milliseconds per apply or solve panel of stacking and padding
its requests into the bucket-wide panel (the ``serve.pack`` spans of the
traced slice)."""

from gspbench import spans


def read(ctx):
    return spans.mean([r.host_ms for r in spans.records("serve.pack")])
