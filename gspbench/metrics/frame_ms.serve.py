"""Mean host milliseconds per frame of the frame lane's
``StreamingFilter.push``, with the stream's own device waits (the
``serve.frame`` spans of the traced slice)."""

from gspbench import spans


def read(ctx):
    return spans.mean([r.host_ms for r in spans.records("serve.frame")])
