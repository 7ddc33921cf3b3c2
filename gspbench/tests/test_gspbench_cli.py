"""``run.py`` exits non-zero and prints no result without the program's
source beside it or without a CUDA device, and names a loaded JAX module;
``calibrate.py`` and ``sweep.py`` refuse to run without a CUDA device."""

import shutil
import subprocess
import sys
import types

import pytest
import torch

from conftest import ROOT

ARGS = ["--workload", "sensor8k_sgwt5.lasso", "--seed", str(2**31 + 3), "--seconds", "1",
        "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, str(root / "gspbench" / "run.py"), *ARGS],
                          capture_output=True, text=True, timeout=300, cwd=root)


def test_benchmark_alone_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gspbench", tmp_path / "gspbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "src" in proc.stderr


def test_no_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("tool", ["calibrate", "sweep"])
def test_tools_refuse_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = {"calibrate": ["--workload", "sensor8k_sgwt5.lasso", "--seeds", "1"],
            "sweep": ["--rates", "100"]}[tool]
    proc = subprocess.run([sys.executable, str(ROOT / "gspbench" / f"{tool}.py"), *args],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_are_named(monkeypatch):
    sys.path.insert(0, str(ROOT / "gspbench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "gspbench"))
    assert run._loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("repro_torch_x"))
    assert run._loaded_forbidden() == ["jax"]
