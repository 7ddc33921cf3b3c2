"""Readings for the limits of ``correct``: the program's and the control's.

From the root of a checkout, on the card::

    python3 gspbench/calibrate.py --workload <cell> --seconds 3 --seeds 11 12 13 ...

For each seed, one process runs the cell's program over a short window at
the cell's own size and load, and judges the sampled answers against the
float64 reference (the program's reading); then the control, the reference
in float32 with TF32 Laplacian products, is judged in the program's place on
the same inputs (the control's reading). The last line is JSON: per check,
each seed's two readings, the largest program reading (the lower end of the
limit) and the smallest control reading (the upper end).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from gspbench import bench

    if not torch.cuda.is_available():
        print("gspbench: calibrate.py reads the program on a CUDA device, and found none",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = bench.find_cell(bench.load_spec(ROOT), args.workload)
    rows = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        program_reading, control_reading = bench.readings(cell, seed, device, args.seconds)
        for check in program_reading:
            rows.setdefault(check, []).append(
                {"seed": seed, "program": program_reading[check], "control": control_reading[check]})
        print(f"seed {seed}: program {program_reading} control {control_reading} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    summary = {check: {"lower": max(r["program"] for r in rs),
                       "upper": min(r["control"] for r in rs), "seeds": rs}
               for check, rs in rows.items()}
    print(json.dumps({"workload": args.workload, "checks": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
