"""Benchmark of ``repro_torch``, the PyTorch and CUDA port.

Run one cell once from the root of a checkout::

    python3 gspbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells; each cell's configuration,
traffic mix and per-layer metric readers are files of their own under
``configs/``, ``traffic/`` and ``metrics/``, found by name. ``reference/``
holds the plain PyTorch reference that decides ``correct``.
"""
