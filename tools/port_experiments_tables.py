"""Render roofline tables from the port's dry-run JSON records.

The port's counterpart of ``tools/make_experiments_tables.py``: the same
tables, from the records of ``python -m repro_torch.launch.dryrun`` (or
``repro_torch.launch.hillclimb``), with the "fits?" column read against
one H100's 80 GB (``repro_torch.launch.roofline.HW.hbm_capacity``).

Why a copy and not an import: the reference tool's ``fmt_table`` holds its
16 GiB capacity inside the function, with nothing to override, so that
function has to be rewritten here; and the port keeps its own copy of what
it needs from the reference's files rather than import them, so that it
stands alone. What is shared is the table layout: a change to the
reference's columns has to be made in both.

  python tools/port_experiments_tables.py experiments/port_dryrun.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.launch.roofline import HW  # noqa: E402


def fmt_table(records, multi_pod: bool) -> str:
    done = [r for r in records
            if "bottleneck" in r and r.get("multi_pod") == multi_pod
            and r.get("kind") != "gsp"]
    skipped = [r for r in records
               if "skipped" in r and r.get("multi_pod") == multi_pod]
    lines = [
        "| cell | fits? mem/dev | compute s | memory s | collective s | "
        "bottleneck | useful FLOPs | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted(done, key=lambda r: (order[r["shape"]], r["arch"])):
        nbytes = r["memory"]["total_per_device"]
        fits = "YES" if nbytes <= HW.hbm_capacity else "no"
        lines.append(
            f"| {r['arch']}.{r['shape']} | {fits} {nbytes / 1e9:.1f}GB "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | {r['bottleneck']} "
            f"| {r.get('useful_flop_ratio', 0):.3f} "
            f"| {r.get('roofline_fraction', 0):.3f} |")
    for r in sorted(skipped, key=lambda r: r["arch"]):
        lines.append(
            f"| {r['arch']}.{r['shape']} | — | — | — | — | "
            f"SKIPPED: {r['skipped'][:40]} | — | — |")
    return "\n".join(lines)


def fmt_gsp(records) -> str:
    gsp = [r for r in records if r.get("kind") == "gsp"]
    lines = [
        "| cell | backend | compute s | memory s | collective s | "
        "bottleneck | coll bytes/dev |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in gsp:
        pod = ".2pod" if r["multi_pod"] else ""
        lines.append(
            f"| sensor_gsp{pod} | {r['backend']} | {r['compute_s']:.6f} "
            f"| {r['memory_s']:.6f} | {r['collective_s']:.6f} "
            f"| {r['bottleneck']} "
            f"| {r['collective_bytes_per_device'] / 1e6:.1f}MB |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    path = Path(argv[0] if argv else "experiments/port_dryrun.json")
    records = json.loads(path.read_text())
    text = "\n".join([
        "### Single-pod (16x16 = 256 H100s)\n", fmt_table(records, False),
        "\n### Multi-pod (2x16x16 = 512 H100s)\n", fmt_table(records, True),
        "\n### The paper's workload (sensor_gsp, 512x512 grid, F=128, M=20)\n",
        fmt_gsp(records)])
    print(text)
    return text


if __name__ == "__main__":
    main()
