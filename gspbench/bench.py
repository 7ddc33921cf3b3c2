"""One run of one cell: the specification, the run and its result.

``BENCHMARK.json`` names each cell's configuration and traffic; the files
are ``configs/<config>.json`` and ``traffic/<traffic>.json`` beside this
module, and each per-layer metric is read by ``metrics/<metric>.py``
(``read(ctx) -> float | None``) in the cells its ``workloads`` list names.
A configuration names its program, ``programs/<program>.py``, which holds
all that is particular to it:

* ``KINDS``: the traffic kinds its traffic files may name, each a driver
  class (``span_names``; ``warm_up``, ``window``, ``operands``,
  ``samples``, ``release``; ``device``);
* ``start(cell, seed, device)``: the inputs from the seed, the program's
  set-up and the driver's warm-up, as ``(inputs, program state, driver,
  seconds per stage)``, the stages including ``prep_s``;
* ``context(cell, inputs)``: what the per-layer readers read beyond the
  generic context, as attributes of ``ctx``;
* ``judge(cell, inputs, driver, samples, precision)``: the numbers
  compared, from the plain reference under ``reference/``: at
  ``"float64"`` the sampled answers, at ``"tf32"`` the control in their
  place;
* ``tiny(cell)``: the cell shrunk in place to a size the CPU tests run in
  seconds (``tests/conftest.py``'s ``tiny_cell``).

``run.py`` puts the checkout's ``src`` on the path before it looks up the
cell, so a program module may import ``repro_torch`` at its top.

``run_cell`` sets the precision, starts the program, runs the window,
reads the metrics, frees the program's state and judges the sampled
answers.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import torch

from gspbench import profiling, work

__all__ = ["HERE", "Cell", "load_spec", "find_cell", "start", "release", "run_cell", "readings"]

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
    program: types.ModuleType


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def _load_module(path: Path, name: str) -> types.ModuleType:
    """The module at ``path``, run afresh and registered as ``name`` (a
    dataclass resolves its string annotations through ``sys.modules``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def find_cell(spec: dict, name: str, here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic, metrics and program."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config_path = here.parent / configs[w["config"]]["file"]
    config = _read_json(config_path)
    traffic = _read_json(here / "traffic" / f"{w['traffic']}.json")
    program = _load_program(config, config_path, here)
    if traffic["kind"] not in program.KINDS:
        raise ValueError(f"traffic {w['traffic']!r} has kind {traffic['kind']!r}, which program "
                         f"{config['program']!r} lacks (it has {sorted(program.KINDS)})")
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=e2e, per_layer=per_layer, program=program)


def _load_program(config: dict, config_path: Path, here: Path) -> types.ModuleType:
    """``programs/<program>.py`` of the configuration's ``program``."""
    if "program" not in config:
        raise ValueError(f"{config_path} names no program: a configuration's \"program\" is a "
                         f"module under {here / 'programs'}")
    path = here / "programs" / f"{config['program']}.py"
    if not path.is_file():
        have = sorted(p.stem for p in (here / "programs").glob("*.py"))
        raise ValueError(f"{config_path} names program {config['program']!r}, and there is no "
                         f"{path} (have {have})")
    return _load_module(path, f"gspbench_program_{config['program']}")


def load_reader(metric: str, here: Path = HERE):
    """``metrics/<metric>.py``'s ``read``."""
    return _load_module(here / "metrics" / f"{metric}.py", f"gspbench_metric_{metric}").read


@dataclasses.dataclass
class ReadContext:
    """What a per-layer metric's reader may read: the cell, the program and
    the operands of its timed calls, the traced slice, the counters of the
    window, the program's set-up seconds, the benchmark's yardsticks, and
    as attributes what the cell's program adds (``extra``, from its
    ``context``)."""

    cell: Cell
    device: torch.device
    prog: object
    operands: dict
    trace: profiling.TraceSummary | None
    counters: dict
    prep_s: float
    extra: dict
    work = work
    profiling = profiling

    def __getattr__(self, name: str):
        extra = self.__dict__.get("extra", {})
        if name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__} has no {name!r}")

    def device_seconds_per_call(self, fn):
        return profiling.device_seconds_per_call(fn, self.device)

    def event_seconds(self, fn):
        return profiling.event_seconds(fn, self.device)


def readings(cell: Cell, seed: int, device: torch.device, seconds: float) -> tuple[dict, dict]:
    """The numbers compared, for the program (a short window at the cell's
    own size and load) and for the control (TF32) judged on the same inputs."""
    inputs, prog, driver, _ = start(cell, seed, device)
    driver.window(seconds, profiling.Tracer(False, device))
    del prog
    samples = release(driver)
    return (cell.program.judge(cell, inputs, driver, samples, "float64"),
            cell.program.judge(cell, inputs, driver, samples, "tf32"))


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
    """The configuration's precision, then the cell's program's ``start``:
    (inputs, program state, driver, seconds per stage)."""
    _set_precision(cell.config)
    return cell.program.start(cell, seed, device)


def release(driver) -> list:
    """The driver's samples, with the program's state freed."""
    samples = driver.samples()
    driver.release()
    gc.collect()
    if driver.device.type == "cuda":
        torch.cuda.empty_cache()
    return samples


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """One run; the result line's fields, ``checks`` last."""
    t_entry = time.perf_counter()
    program = cell.program
    tracer = profiling.Tracer(trace, device, program.KINDS[cell.traffic["kind"]].span_names)
    inputs, prog, driver, stages = start(cell, seed, device)
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

    if trace:
        metrics = _read_per_layer(cell, ReadContext(
            cell=cell, device=device, prog=prog, operands=driver.operands(),
            trace=tracer.summary, counters=out["counters"], prep_s=stages["prep_s"],
            extra=program.context(cell, inputs)))
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    del prog
    numbers = program.judge(cell, inputs, driver, release(driver), "float64")
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
