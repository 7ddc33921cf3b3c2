"""99th percentile, over the traced slice's requests of every lane, of the
time a request waited in the engine's scheduler: its panel's start minus
its submit time, on the engine's clock (the ``serve.panel`` spans)."""

import numpy as np

from gspbench import spans


def read(ctx):
    waits = [w for r in spans.records("serve.panel") for w in r.attrs.get("queue_wait_s", ())]
    return 1e3 * float(np.percentile(waits, 99)) if waits else None
