"""A configuration names its program, ``programs/<program>.py``, so a second
program joins the harness as new files only.

A copy of ``gspbench/`` and ``BENCHMARK.json`` gains a toy program (``y =
A x`` with a seeded ``A`` in plain torch, one closed-loop traffic kind; it
imports ``repro_torch`` at its top), its configuration and traffic, a plain
reference, one per-layer reader and the entries appended to
``BENCHMARK.json``. Its cell runs through the copy's ``bench.run_cell`` in a
subprocess whose path puts the copy first: correct, with the reader's
metric reported, and not correct with an output entry altered where the
program produces it. The copy's ``run.py`` looks the cell up, and the copy's
own tests pass with the toy among the cells. No file the copy started
with changes. A configuration without a program, an unknown program and a
traffic kind the program lacks are refused by name.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from gspbench import bench

from conftest import ROOT

SPEC = bench.load_spec(ROOT)
CELL = "sensor8k_sgwt5.lasso"
TOY_CELL = "toy64_affine.matvec"

TOY_FILES = {
    "programs/toy_affine.py": '''
        """A toy program: ``y = A x`` with a seeded float32 ``A``, driven in a
        closed loop; the control is the reference with TF32 operands."""

        from __future__ import annotations

        import dataclasses
        import time

        # repro_torch at the top, as a program of the port would have it; a bare
        # annotation (``Tensor``) makes the dataclass look the module up.
        import torch
        from repro_torch import resolve_device
        from torch import Tensor

        from gspbench import drivers
        from gspbench.reference import toy_affine as reference


        @dataclasses.dataclass
        class Affine:
            a: Tensor

            def apply(self, x):
                return self.a @ x


        class MatvecClosedLoop:
            kind = "matvec_closed"
            span_names = ("matvec",)

            def __init__(self, prog, traffic, seed, gen):
                self.prog, self.traffic, self.device = prog, traffic, prog.a.device
                self.pool = [torch.randn((prog.a.shape[1], traffic["batch"]), generator=gen,
                                         device=self.device) for _ in range(traffic["pool"])]
                self.kept = []

            def warm_up(self):
                self.prog.apply(self.pool[0])

            def window(self, seconds, tracer):
                count, t0 = 0, time.perf_counter()
                trace = drivers.TraceSlice(tracer, t0, seconds, self.traffic["trace_s"])
                while time.perf_counter() - t0 < seconds:
                    trace.tick()
                    idx = count % len(self.pool)
                    with tracer.span("matvec"):
                        y = self.prog.apply(self.pool[idx])
                    if len(self.kept) < self.traffic["samples"]:
                        self.kept.append((idx, y))
                    count += 1
                trace.close()
                rate = count * self.traffic["batch"] / (time.perf_counter() - t0)
                return {"metrics": {"matvec_columns_per_s": rate}, "attempted": count,
                        "failed": 0, "unanswered": 0, "counters": {"matvecs": count}}

            def operands(self):
                return {"x": self.pool[0]}

            def samples(self):
                return [("matvec_rel_err", idx, y) for idx, y in self.kept]

            def release(self):
                self.prog = None


        KINDS = {MatvecClosedLoop.kind: MatvecClosedLoop}


        def start(cell, seed, device):
            c, device = cell.config, resolve_device(device)
            t0 = time.perf_counter()
            placement = torch.Generator(device=device).manual_seed(c["matrix_seed"])
            a = torch.randn((c["rows"], c["cols"]), generator=placement, device=device)
            gen = torch.Generator(device=device).manual_seed(seed % 2**63)
            t_prep = time.perf_counter()
            prog = Affine(a)
            t_driver = time.perf_counter()
            driver = KINDS[cell.traffic["kind"]](prog, cell.traffic, seed, gen)
            driver.warm_up()
            stages = {"inputs_s": t_prep - t0, "prep_s": t_driver - t_prep,
                      "warm_up_s": time.perf_counter() - t_driver}
            return a, prog, driver, stages


        def context(cell, a):
            return {"flops_per_column": 2 * a.shape[0] * a.shape[1]}


        def judge(cell, a, driver, samples, precision):
            numbers = {}
            for check, idx, y in samples:
                x = driver.pool[idx]
                if precision == "tf32":
                    y = reference.matvec_tf32(a, x)
                err = drivers.rel_err(y, reference.matvec(a, x))
                numbers[check] = max(numbers.get(check, 0.0), err)
            return numbers


        def tiny(cell):
            """The toy runs on the CPU at its own size."""
    ''',
    "reference/toy_affine.py": '''
        """The toy program's plain reference: ``A x`` in float64, and the
        control, ``A x`` in float32 with TF32 operands."""

        import torch

        from gspbench.reference.graph import round_tf32


        def matvec(a, x):
            return a.to(torch.float64) @ x.to(torch.float64)


        def matvec_tf32(a, x):
            return round_tf32(a) @ round_tf32(x)
    ''',
    "metrics/matvec_gflops.toy.py": '''
        """GFLOP/s of one matvec on a pool panel: the program's operations per
        column times the panel's columns over the call's median time."""


        def read(ctx):
            x = ctx.operands.get("x")
            if x is None:
                return None
            seconds = ctx.event_seconds(lambda: ctx.prog.apply(x))
            return ctx.flops_per_column * x.shape[1] / seconds / 1e9
    ''',
    "configs/toy64_affine.json": {"name": "toy64_affine", "program": "toy_affine",
                                  "source": "a toy of the harness's tests", "rows": 64,
                                  "cols": 128, "matrix_seed": 7, "tf32": False},
    "traffic/matvec_closed16.json": {"kind": "matvec_closed", "why": "back-to-back matvecs",
                                     "batch": 16, "pool": 4, "samples": 4, "trace_s": 0.2,
                                     "limits": {"matvec_rel_err": 1e-5}},
}
TOY_ENTRIES = {
    "configs": [{"name": "toy64_affine", "source": "a toy of the harness's tests",
                 "file": "gspbench/configs/toy64_affine.json", "reduced": [],
                 "why": "a second program"}],
    "workloads": [{"name": TOY_CELL, "config": "toy64_affine", "traffic": "matvec_closed16",
                   "chips": 1, "why": "closed loop of 16-column matvecs"}],
    "end_to_end": [{"name": "matvec_columns_per_s", "unit": "columns/s", "better": "higher",
                    "bound": 0.05, "source": "host_clock", "workloads": [TOY_CELL]}],
    "per_layer": [{"name": "matvec_gflops.toy", "unit": "GFLOP/s", "better": "higher",
                   "source": "host_clock", "layer": "toy", "moves": "matvec_columns_per_s",
                   "workloads": [TOY_CELL]}],
}

RUN = textwrap.dedent('''
    import json, sys, time
    from pathlib import Path

    import torch

    from gspbench import bench

    root = Path.cwd()
    assert bench.HERE == root / "gspbench", bench.HERE
    cell = bench.find_cell(bench.load_spec(root), sys.argv[1])
    if sys.argv[3] == "fault":
        real = cell.program.Affine.apply

        def altered(self, x):
            y = real(self, x).clone()
            y[0, 0] += 1e-3 * y.abs().max()
            return y

        cell.program.Affine.apply = altered
    res = bench.run_cell(cell, 2**31 + 5, 1.0, sys.argv[2] == "1", torch.device("cpu"),
                         time.perf_counter())
    print(json.dumps(res))
''')


def _files(root):
    """The benchmark's files in a copy: ``BENCHMARK.json`` and ``gspbench/``."""
    paths = [root / "BENCHMARK.json", *sorted((root / "gspbench").rglob("*"))]
    return {p.relative_to(root): p.read_bytes() for p in paths
            if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path, ignore=("__pycache__",)):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gspbench", tmp_path / "gspbench",
                    ignore=shutil.ignore_patterns(*ignore))
    return tmp_path


def _env(**extra):
    """The environment without the caller's ``PYTHONPATH``, plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return dict(env, PYTHONDONTWRITEBYTECODE="1", OMP_NUM_THREADS="2", **extra)


def _run(root, trace, fault=""):
    env = _env(PYTHONPATH=os.pathsep.join([str(root), str(root / "src")]))
    proc = subprocess.run([sys.executable, "-c", RUN, TOY_CELL, str(trace), fault or "none"],
                          capture_output=True, text=True, timeout=300, cwd=root, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_second_program_runs_from_new_files(tmp_path):
    root = _copy(tmp_path)
    (root / "src").symlink_to(ROOT / "src", target_is_directory=True)
    before = _files(root)
    for rel, body in TOY_FILES.items():
        text = json.dumps(body) if isinstance(body, dict) else textwrap.dedent(body).lstrip()
        assert not (root / "gspbench" / rel).exists(), rel
        (root / "gspbench" / rel).write_text(text)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in TOY_ENTRIES.items():
        spec[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))

    plain = _run(root, 0)
    assert plain["correct"], plain["checks"]
    assert plain["failed"] == 0 and plain["attempted"] > 0 and list(plain)[-1] == "checks"
    assert set(plain["metrics"]) == {"setup_s", "matvec_columns_per_s"}
    assert plain["setup"]["stages_s"]["prep_s"] >= 0.0
    traced = _run(root, 1)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {"matvec_gflops.toy"}
    assert traced["metrics"]["matvec_gflops.toy"]["value"] > 0.0
    assert traced["device"]["window_s"] > 0.0
    faulty = _run(root, 0, "fault")
    assert not faulty["correct"], faulty["checks"]
    assert faulty["checks"]["matvec_rel_err"]["value"] > 1e-5

    # run.py puts src on the path before the lookup that loads the program.
    proc = subprocess.run([sys.executable, "gspbench/run.py", "--workload", TOY_CELL, "--seed",
                           str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=root, env=_env())
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
    else:
        assert proc.returncode == 1 and proc.stdout == "", proc.stderr[-4000:]
        assert f"{TOY_CELL} needs 1 CUDA device(s)" in proc.stderr

    # The copy's own tests take the toy's cell as one of theirs.
    proc = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
                           "-p", "no:randomly", "gspbench/tests", "--deselect",
                           "gspbench/tests/test_gspbench_programs.py::"
                           "test_a_second_program_runs_from_new_files"],
                          capture_output=True, text=True, timeout=900, cwd=root, env=_env())
    assert proc.returncode == 0, proc.stdout[-6000:]
    for test in ("test_gspbench_spec.py::test_config_entries[toy64_affine]",
                 f"test_gspbench_spec.py::test_cell_resolves[{TOY_CELL}]",
                 f"test_gspbench_rehearsal.py::test_rehearsal[{TOY_CELL}-trace0]",
                 f"test_gspbench_rehearsal.py::test_rehearsal[{TOY_CELL}-trace1]",
                 f"test_gspbench_control.py::test_control_fails_on_the_cpu[{TOY_CELL}]",
                 "test_gspbench_programs.py::"
                 f"test_each_cell_runs_the_program_its_configuration_names[{TOY_CELL}]"):
        assert re.search(re.escape(test) + r" PASSED", proc.stdout), test

    after = _files(root)
    new = {rel for rel in after if rel not in before}
    assert new == {Path("gspbench", rel) for rel in TOY_FILES}
    for rel, data in before.items():
        if rel.name != "BENCHMARK.json":
            assert after[rel] == data, rel
    orig = json.loads(before[Path("BENCHMARK.json")])
    grown = json.loads(after[Path("BENCHMARK.json")])
    assert set(grown) == set(orig)
    for key in orig:
        if key in TOY_ENTRIES:
            assert grown[key] == orig[key] + TOY_ENTRIES[key], key
        else:
            assert grown[key] == orig[key], key


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_runs_the_program_its_configuration_names(name):
    cell = bench.find_cell(SPEC, name)
    assert cell.program.__file__ == str(ROOT / "gspbench" / "programs"
                                        / f"{cell.config['program']}.py")
    assert cell.traffic["kind"] in cell.program.KINDS
    assert all(callable(getattr(cell.program, f)) for f in ("start", "context", "judge", "tiny"))


def _edit(path, change):
    data = json.loads(path.read_text())
    change(data)
    path.write_text(json.dumps(data))


def test_a_configuration_without_a_program_is_refused(tmp_path):
    here = _copy(tmp_path, ("__pycache__", "tests")) / "gspbench"
    path = here / "configs" / "sensor8k_sgwt5.json"
    _edit(path, lambda c: c.pop("program"))
    with pytest.raises(ValueError, match=re.escape(str(path)) + ".*names no program"):
        bench.find_cell(SPEC, CELL, here=here)


def test_an_unknown_program_is_refused(tmp_path):
    here = _copy(tmp_path, ("__pycache__", "tests")) / "gspbench"
    path = here / "configs" / "sensor8k_sgwt5.json"
    _edit(path, lambda c: c.update(program="no_such_program"))
    with pytest.raises(ValueError, match=re.escape(str(path)) + ".*'no_such_program'.*sensor_sgwt"):
        bench.find_cell(SPEC, CELL, here=here)


def test_a_traffic_kind_the_program_lacks_is_refused(tmp_path):
    here = _copy(tmp_path, ("__pycache__", "tests")) / "gspbench"
    _edit(here / "traffic" / "lasso_fista32.json", lambda t: t.update(kind="matvec_closed"))
    with pytest.raises(ValueError, match="'matvec_closed'.*'sensor_sgwt'.*'lasso_closed'"):
        bench.find_cell(SPEC, CELL, here=here)
