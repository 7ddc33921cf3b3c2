"""Perf-iteration tool: re-trace one cell with ParallelConfig overrides
and append the labelled record to the experiment log.

Mirrors ``repro/launch/hillclimb.py``; the trace is the dry run's
(``launch.dryrun.run_cell``, on ``meta`` tensors, no card).

  python -m repro_torch.launch.hillclimb --arch llama3_405b --shape train_4k \\
      --set attn_impl=chunked seq_parallel=true microbatches=8 \\
      --tag chunked+sp+mb8 --out experiments/perf_hillclimb.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.cells import default_parallel, shape_with_frontend
from repro_torch.launch.dryrun import SHAPES, run_cell

__all__ = ["parse_overrides", "main"]


def parse_overrides(pairs) -> dict:
    """``key=value`` strings to a dict: booleans, then ints, then floats,
    else the string."""
    out = {}
    for pair in pairs:
        k, v = pair.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", default="experiments/perf_hillclimb.json")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    shape = shape_with_frontend(args.arch, SHAPES[args.shape])
    par = default_parallel(args.arch, shape, **overrides)
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod, par=par)
    rec["tag"] = args.tag
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    existing = json.loads(out.read_text()) if out.exists() else []
    existing.append(rec)
    out.write_text(json.dumps(existing, indent=1))
    print(f"[{args.tag}] appended -> {out}")
    return rec


if __name__ == "__main__":
    main()
