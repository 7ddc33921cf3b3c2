"""The knee of a serving cell: its traffic at a list of rates.

From the root of a checkout, on the card::

    python3 gspbench/sweep.py --workload sensor8k_sgwt5.serve --seconds 20 --rates 1000 2000 ...

One process sets the cell up once and drives the cell's seeded trace at
each rate in turn on the wall clock (``ServeOpenLoop.run_trace``). Each
row gives the requests due, the share served, the backlog (requests due
and not yet answered) at the close and how far it grew over the window's
second half, p50 and p99 latency, the generator's p99 lateness, panels,
the engine's busy seconds and the pad waste. A rate is sustained when at
least 99 % of the requests due are served and the backlog grew by less
than one panel width over the second half; the knee is the highest rate
sustained, and the cell's rate four fifths of it. The last line is JSON.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="sensor8k_sgwt5.serve")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from gspbench import bench

    if not torch.cuda.is_available():
        print("gspbench: sweep.py reads the program on a CUDA device, and found none",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = bench.find_cell(bench.load_spec(ROOT), args.workload)
    _, _, driver, _ = bench.start(cell, args.seed, device)
    width = cell.traffic["max_panel"]
    rows, knee = [], None
    print("rate/s requests served% backlog_at_close backlog_growth p50_ms p99_ms lag_p99_ms "
          "panels busy_s pad%")
    for rate in args.rates:
        rep = driver.run_trace(args.seconds, rate)
        served = 100.0 * rep["served"] / rep["requests"]
        pad = 100.0 * rep["pad_slots"] / max(rep["panel_slots"], 1)
        print(f"{rate:g} {rep['requests']} {served:.2f} {rep['backlog_at_close']} "
              f"{rep['backlog_growth']:.1f} "
              f"{rep['p50_ms']:.3f} {rep['p99_ms']:.3f} {rep['lag_p99_ms']:.3f} "
              f"{rep['panels']} {rep['busy_s']:.3f} {pad:.2f}", flush=True)
        rows.append(dict(rep, rate=rate))
        if rep["backlog_growth"] < width and served >= 99.0:
            knee = rate if knee is None else max(knee, rate)
    print(json.dumps({"workload": args.workload, "knee": knee,
                      "rate": None if knee is None else 0.8 * knee, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
