"""The port's package rules: it imports neither ``jax`` nor ``repro``,
its entry points default to CUDA and raise without it, ``interop``
carries reference state across, and the quickstart runs on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop, resolve_device
from repro_torch.core import graph as tgraph

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 36  # every module of the slices was imported


def test_chip_smoke_imports_neither_jax_nor_reference():
    text = (SRC.parent / "chip_smoke.py").read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert mod.split(".")[0] not in ("jax", "repro"), line


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgraph.connected_sensor_graph(gen, n=50)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgraph.random_sensor_graph(gen, n=50)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgraph.grid_graph(3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.sensor_graph_from_numpy(np.zeros((2, 2)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.block_ell_from_numpy(np.zeros((1, 1, 8, 8)), np.zeros((1, 1)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgraph.ring_graph(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgraph.torus_graph(2, 2)
    from repro_torch.core import collectives, distributed

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collectives.StackedMesh(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.build_partition_plan(np.zeros((4, 4)), None, 2)
    from repro_torch.apps import streaming_denoise
    from repro_torch.dynamic import mobile_sensor_scenario
    from repro_torch.filters import GraphFilter
    from repro_torch.stream import StreamingFilter, StreamingLasso

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mobile_sensor_scenario(16, 2)
    g = tgraph.grid_graph(3, device="cpu")
    filt = GraphFilter.from_coefficients(np.ones((1, 3)), 8.0, graph=g)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingFilter(filt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingLasso(filt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming_denoise(g, [np.zeros(9, np.float32)])
    from repro_torch import distributed_denoising, distributed_wavelet_ista, quickstart

    for module in (quickstart, distributed_denoising, distributed_wavelet_ista):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main()
    assert resolve_device("cpu") == torch.device("cpu")


def test_interop_carries_reference_state():
    a = np.array([[0.0, 0.5], [0.5, 0.0]])
    g = interop.sensor_graph_from_numpy(a, np.zeros((2, 2)), "cpu")
    assert g.adjacency.dtype == torch.float32 and g.n_edges == 1
    with pytest.raises(ValueError, match="square"):
        interop.sensor_graph_from_numpy(np.zeros((2, 3)), device="cpu")
    bell = interop.block_ell_from_numpy(np.ones((2, 1, 8, 8)), np.array([[1], [0]]), "cpu")
    assert bell.blocks.dtype == torch.float32 and bell.cols.dtype == torch.int32
    with pytest.raises(ValueError, match="block columns"):
        interop.block_ell_from_numpy(np.ones((2, 1, 8, 8)), np.array([[2], [0]]), "cpu")
    filt = interop.filter_from_numpy(np.ones((1, 3)), 4.0, g)
    assert filt.graph is g and filt.gram_coeffs.shape == (5,)


def test_quickstart_runs_on_cpu():
    from repro_torch import quickstart

    res = quickstart.main(device="cpu")
    assert 0.2 < res["noisy_mse"] < 0.3 and res["denoised_mse"] < 0.02
    assert res["bsr_fused_err"] < 1e-4 and res["bsr_stepwise_err"] < 1e-4
    assert res["ssl_accuracy"] > 0.8
