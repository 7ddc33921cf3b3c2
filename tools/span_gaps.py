"""Split one cell's traced slice by the program's own spans.

From the root of a checkout, on a card::

    python3 tools/span_gaps.py --workload sensor8k_sgwt5.serve --seed 7 --seconds 20

Runs the cell as ``gspbench/run.py --trace 1`` does (set-up, warm-up, the
window with its traced slice a quarter in), but hands the tracer the
program's span names (``repro_torch.telemetry.SPAN_NAMES``) beside the
benchmark's, so that ``gspbench.profiling.summarize`` names each idle gap
of the device after the innermost span open on the host, program spans
included. Prints one JSON line:

* ``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` of the slice;
* ``spans``: per span name of the slice's telemetry session, its count,
  summed, median and largest host ms, summed self host ms (own time less
  its children's) and, for spans with CUDA events, summed device ms;
* ``clock_us``: the recorder's start times against the profiler's own
  event starts for the same ranges (median and largest offset, pairs).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _clock_offsets(prof, session) -> dict:
    """Recorder start (``time.time_ns``) against the profiler's event start
    for the same span, pairing the n-th record of a name with the n-th
    event of that name where both count alike."""
    base_ns = prof.profiler.kineto_results.trace_start_ns()
    names = {r.name for r in session.records}
    events: dict[str, list] = {}
    for ev in prof.events():
        if ev.name in names:
            events.setdefault(ev.name, []).append(ev.time_range.start)
    offsets = []
    for name, starts in events.items():
        recs = session.named(name)
        if len(recs) != len(starts):
            continue
        for rec, start_us in zip(recs, sorted(starts)):
            offsets.append(abs(rec.start_ns - (base_ns + 1e3 * start_us)) * 1e-3)
    if not offsets:
        return {"pairs": 0}
    return {"pairs": len(offsets), "median": statistics.median(offsets), "max": max(offsets)}


def _span_totals(session) -> dict:
    child_host: dict[int, float] = {}
    for r in session.records:
        if r.parent is not None:
            child_host[id(r.parent)] = child_host.get(id(r.parent), 0.0) + r.host_ms
    out: dict[str, dict] = {}
    each: dict[str, list] = {}
    for r in session.records:
        t = out.setdefault(r.name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0})
        t["count"] += 1
        t["host_ms"] += r.host_ms
        t["self_host_ms"] += r.host_ms - child_host.get(id(r), 0.0)
        each.setdefault(r.name, []).append(r.host_ms)
        device = r.device_ms()
        if device is not None:
            t["device_ms"] = t.get("device_ms", 0.0) + device
    for name, values in each.items():
        out[name].update(host_ms_median=statistics.median(values), host_ms_max=max(values))
    return out


def breakdown(cell, seed: int, seconds: float, device) -> dict:
    """Run ``cell`` once with the program's spans in the tracer's names."""
    from gspbench import bench, drivers, profiling
    from repro_torch import telemetry

    telemetry.clear()
    names = tuple(drivers.KINDS[cell.traffic["kind"]].span_names) + tuple(telemetry.SPAN_NAMES)
    tracer = profiling.Tracer(True, device, names)
    _, prog, driver, _ = bench.start(cell, seed, device)
    tracer.warm_up()
    driver.window(seconds, tracer)
    session = telemetry.sessions()[0]
    clock = _clock_offsets(tracer._prof, session)
    summary = tracer.finish()
    spans = _span_totals(session)
    del prog
    driver.release()
    return {"workload": cell.name, "seed": seed, "busy_s": summary.busy_s,
            "window_s": summary.window_s, "idle_share": summary.idle_share,
            "idle_gaps": summary.idle_gaps, "device_ops": summary.device_ops,
            "spans": spans, "dropped": session.dropped, "clock_us": clock}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gspbench import run as bench_run

    bench_run._environment()
    import torch

    from gspbench import bench

    if not torch.cuda.is_available():
        print("span_gaps: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = bench.find_cell(bench.load_spec(ROOT), args.workload)
    print(json.dumps(breakdown(cell, args.seed, args.seconds, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
