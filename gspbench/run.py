"""Run one cell of the benchmark once and print its result line.

From the root of a checkout::

    python3 gspbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, ``setup`` (seconds per stage of set-up and set-up's own
memory peak; ``device.memory_peak_bytes`` is the window's), and last
``checks``, each number compared with its limit. The same numbers are the
last lines of standard error. The run exits
non-zero, printing no result, without a CUDA device (or fewer than the
cell asks for), without the program's source beside the benchmark, or when
the process has loaded JAX, Flax, the JAX package or ``benchmarks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})
THREADS = "4"


def _environment() -> None:
    """Caches at fixed paths inside the checkout, few host threads, and
    the profiler's CUPTI kept attached between sessions (with the default
    teardown, short sessions came back empty every second or third time)."""
    cache = ROOT / ".gspbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TEARDOWN_CUPTI"] = "0"
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = THREADS
    sys.path[0] = str(ROOT)


def _loaded_forbidden() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (read after the run, so that its start-up is not set-up time)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


def _finite(value):
    return value if value is None or math.isfinite(value) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"gspbench: the program's source {ROOT / 'src' / 'repro_torch'} is missing",
              file=sys.stderr)
        return 2

    import torch

    from gspbench import bench

    cell = bench.find_cell(bench.load_spec(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gspbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 1
    sys.path.insert(1, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)

    print(f"gspbench: {args.workload} seed {args.seed} seconds {args.seconds} "
          f"trace {args.trace} on {_card()}", file=sys.stderr)

    found = _loaded_forbidden()
    if found:
        print(f"gspbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    stages = " ".join(f"{k} {v:.3f}" for k, v in result["setup"]["stages_s"].items())
    print(f"gspbench: setup {stages}; setup memory peak {result['setup']['memory_peak_bytes']} "
          f"bytes", file=sys.stderr)
    for name, c in result["checks"].items():
        c["value"] = _finite(c["value"])
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
