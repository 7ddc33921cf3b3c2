"""One run of one cell: the specification, the run and its result.

``BENCHMARK.json`` names each cell's configuration and traffic; the files
are ``configs/<config>.json`` and ``traffic/<traffic>.json`` beside this
module, and each per-layer metric is read by ``metrics/<metric>.py``
(``read(ctx) -> float | None``) in the cells its ``workloads`` list names.
``run_cell`` makes the inputs from the seed, builds the program, warms up,
runs the window, reads the metrics, frees the program's state and judges
the sampled answers against the plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path

import torch

from gspbench import drivers, loadgen, profiling, program, work
from gspbench.reference import cheb
from gspbench.reference.graph import sensor_laplacian

__all__ = ["HERE", "Cell", "load_spec", "find_cell", "start", "release", "run_cell", "judge",
           "readings"]

HERE = Path(__file__).resolve().parent


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(spec: dict, name: str, here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(here.parent / configs[w["config"]]["file"])
    traffic = _read_json(here / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=e2e, per_layer=per_layer)


def load_reader(metric: str, here: Path = HERE):
    """``metrics/<metric>.py``'s ``read``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gspbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class ReadContext:
    """What a per-layer metric's reader may read: the cell, the program and
    the operands of its timed calls, the traced slice, the counters of the
    window, the graph's nonzeros (from the reference's graph) and the
    benchmark's yardsticks."""

    cell: Cell
    device: torch.device
    prog: program.Program
    operands: dict
    trace: profiling.TraceSummary | None
    counters: dict
    prep_s: float
    nnz: int
    work = work
    profiling = profiling

    def device_seconds_per_call(self, fn):
        return profiling.device_seconds_per_call(fn, self.device)

    def event_seconds(self, fn):
        return profiling.event_seconds(fn, self.device)


def judge(driver, samples, precision: str, lap, config: dict) -> dict:
    """The numbers compared: per check, the worst relative error of the
    sampled answers (``samples``: (check, key, answer)) against the float64
    reference. ``precision="tf32"`` judges the control, the reference in
    float32 with TF32 Laplacian products, in the answers' place."""
    lmax = lap.lmax_bound()
    coeffs = cheb.cheb_coefficients(cheb.sgwt_bank(lmax, config["n_scales"], config["sgwt_k"]),
                                    config["order"], lmax)
    ref64 = lap.operator("float64")
    numbers, by_check = {}, {}
    for check, key, answer in samples:
        by_check.setdefault(check, []).append((key, answer))
    for check, items in sorted(by_check.items()):
        keys = [k for k, _ in items]
        want = driver.reference(check, keys, ref64, coeffs, lmax, torch.float64)
        if precision == "tf32":
            got = driver.reference(check, keys, lap.operator("tf32"), coeffs, lmax, torch.float32)
            items = [(k, got[k]) for k in keys]
        numbers[check] = max(drivers.rel_err(answer, want[k]) for k, answer in items)
    return numbers


def readings(cell: Cell, seed: int, device: torch.device, seconds: float) -> tuple[dict, dict]:
    """The numbers compared, for the program (a short window at the cell's
    own size and load) and for the control judged on the same inputs."""
    coords, prog, driver, _ = start(cell, seed, device)
    driver.window(seconds, profiling.Tracer(False, device))
    del prog
    lap = reference_laplacian(cell, coords)
    samples = release(driver)
    return (judge(driver, samples, "float64", lap, cell.config),
            judge(driver, samples, "tf32", lap, cell.config))


def _set_precision(config: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


def _read_per_layer(cell: Cell, ctx: ReadContext) -> dict:
    metrics = {}
    for m in cell.per_layer:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def start(cell: Cell, seed: int, device: torch.device):
    """The deployment's sensors (from the configuration's ``graph_seed``: one
    field, whose tiling sets the work), the inputs from the run's seed, the
    program's set-up and the driver's warm-up: (positions, program, driver,
    seconds per stage: ``positions_s`` (with the device's first use),
    ``prep_s``, ``warm_up_s``)."""
    _set_precision(cell.config)
    t0 = time.perf_counter()
    placement = torch.Generator(device=device).manual_seed(cell.config["graph_seed"])
    coords = loadgen.sensor_positions(placement, cell.config["n_vertices"], device)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    _sync(device)
    t_prep = time.perf_counter()
    prog = program.build(cell.config, coords)
    _sync(device)
    t_driver = time.perf_counter()
    driver = drivers.KINDS[cell.traffic["kind"]](prog, cell.traffic, seed, gen)
    driver.warm_up()
    stages = {"positions_s": t_prep - t0, "prep_s": t_driver - t_prep,
              "warm_up_s": time.perf_counter() - t_driver}
    return coords, prog, driver, stages


def release(driver) -> list:
    """The driver's samples, with the program's state freed."""
    samples = driver.samples()
    driver.release()
    gc.collect()
    if driver.device.type == "cuda":
        torch.cuda.empty_cache()
    return samples


def reference_laplacian(cell: Cell, coords: torch.Tensor):
    sigma, kappa = program.scaled_kernel(cell.config)
    return sensor_laplacian(coords, sigma, kappa)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """One run; the result line's fields, ``checks`` last."""
    t_entry = time.perf_counter()
    tracer = profiling.Tracer(trace, device, drivers.KINDS[cell.traffic["kind"]].span_names)
    coords, prog, driver, stages = start(cell, seed, device)
    tracer.warm_up()
    setup_s = time.perf_counter() - t_start
    stages = {"entry_s": t_entry - t_start, **stages,
              "profiler_s": setup_s - (t_entry - t_start) - sum(stages.values())}
    # The window's own peak: what the deployment holds while it serves plus
    # what the window allocates, without set-up's transients (the dense
    # (N, N) graph build).
    setup_peak = _peak_and_reset(device)
    out = driver.window(seconds, tracer)
    peak = _peak_and_reset(device)
    tracer.finish()

    lap = reference_laplacian(cell, coords)
    if trace:
        metrics = _read_per_layer(cell, ReadContext(
            cell=cell, device=device, prog=prog, operands=driver.operands(),
            trace=tracer.summary, counters=out["counters"], prep_s=stages["prep_s"],
            nnz=lap.nnz))
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    del prog
    numbers = judge(driver, release(driver), "float64", lap, cell.config)
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in cell.traffic["limits"].items()}
    correct = out["unanswered"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if trace and tracer.summary is not None:
        s = tracer.summary
        result["device"].update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    result["setup"] = {"stages_s": stages, "memory_peak_bytes": setup_peak}
    result["checks"] = checks
    return result


def _peak_and_reset(device: torch.device) -> int:
    """The device's peak allocated bytes since the last reset; then reset."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return int(peak)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
