"""Time the port's deployment-shape apply from one checkout, for comparing
two commits on one card.

Builds phase 4's deployment filter of ``chip_smoke.py`` (N = 8192 sensors,
the SGWT bank with eta = 5, M = 20, F = 256) from the ``src/`` of the
checkout given as the argument, and prints the median CUDA-event ms of
the fused and the stepwise ``bsr`` apply (30 runs after 5 warm-ups). One
checkout per process (both import as ``repro_torch``); alternate them in
one call on one card, for example with the parent unpacked by
``git archive`` into ``_archive/parent`` and the change into ``_archive``:

    for t in _archive/parent _archive _archive _archive/parent; do
        python3 tools/port_apply_ab.py $t; done
"""

import math
import statistics
import sys

import torch

tree = sys.argv[1]
sys.path.insert(0, tree + "/src")
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import multipliers as tmult  # noqa: E402
from repro_torch.filters import GraphFilter  # noqa: E402

dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
s = math.sqrt(500 / 8192)
g = tgraph.random_sensor_graph(torch.Generator().manual_seed(7), 8192, 0.074 * s, 0.075 * s,
                               device=dev)
filt = GraphFilter.from_multipliers(tmult.sgwt_filter_bank(float(g.lmax_bound()), 4), 20, graph=g)
filt.prepare_backend("bsr")
sig = torch.randn(8192, 256, generator=torch.Generator().manual_seed(1)).to(dev)


def med(fn, reps=30, warm=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


print(f"{tree}: fused {med(lambda: filt.apply(sig, backend='bsr')):.4f} ms, stepwise "
      f"{med(lambda: filt.apply(sig, backend='bsr', fuse=False)):.4f} ms", flush=True)
