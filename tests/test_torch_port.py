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
             if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_reference():
    # nor ml_dtypes, which the card's machine lacks (checkpoints store
    # bf16 and fp8 through torch's own byte views)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 91  # every module of the slices was imported


def test_chip_smoke_imports_neither_jax_nor_reference():
    text = (SRC.parent / "chip_smoke.py").read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert mod.split(".")[0] not in ("jax", "repro", "ml_dtypes"), line


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
    from repro_torch.serve import AsyncGraphFilterEngine, GraphFilterEngine

    for engine in (GraphFilterEngine, AsyncGraphFilterEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine(filt)
        cpu_engine = engine(filt, backend="dense", device="cpu")
        assert cpu_engine.device == torch.device("cpu")
    sync = GraphFilterEngine(filt, backend="dense", panel_width=1, device="cpu")
    (out,) = sync.submit(np.ones(9, np.float32))
    assert out.shape == (1, 9) and out.device.type == "cpu"
    asyn = AsyncGraphFilterEngine(filt, backend="dense", device="cpu")
    assert asyn.wait(asyn.submit(np.ones(9, np.float32), now=0.0), now=0.0).shape == (1, 9)
    from repro_torch import distributed_denoising, distributed_wavelet_ista, quickstart

    for module in (quickstart, distributed_denoising, distributed_wavelet_ista):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main()
    assert resolve_device("cpu") == torch.device("cpu")


def test_substrate_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    from repro_torch import checkpoint, gossip_consensus, streaming_denoising

    for module in (gossip_consensus, streaming_denoising):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main()
    checkpoint.save(tmp_path, 1, {"x": torch.zeros(2)})
    for restore in (checkpoint.restore, checkpoint.restore_resharded):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            restore(tmp_path, 1, {"x": torch.zeros(2)})
    assert checkpoint.restore(tmp_path, 1, {"x": torch.zeros(2)}, device="cpu")["x"].shape == (2,)


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    from repro_torch import serve_lm
    from repro_torch.configs import registry
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.models.config import ParallelConfig
    from repro_torch.serve import ServeEngine

    cfg = registry.get_smoke("gemma2_2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.main()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "gemma2_2b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_cache(cfg, 1, 8, cfg.dtype())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.lm_params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.cache_from_numpy({"pos": np.zeros((), np.int32)})
    params, _ = lm.init(torch.Generator(), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg=cfg, par=ParallelConfig(), params=params)
    assert ServeEngine(cfg=cfg, par=ParallelConfig(), params=params,
                       device="cpu").device == torch.device("cpu")
    # The dry run is device-free by design: it traces on ``meta`` tensors
    # and takes no device, as the reference's runs on fake host devices.
    from repro_torch.launch import dryrun

    (rec,) = dryrun.main(["--arch", "gemma2_2b", "--shape", "decode_32k"])
    assert rec["n_chips"] == 256 and rec["analysis"] == "aten-trace-meta"


def test_resolve_device_names_the_current_card(monkeypatch):
    # A bare "cuda" must compare equal to the device of tensors made on
    # it (cuda:<current>), or a filter's graph is refused as on another
    # device by the streams and engines that default to "cuda".
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_pinned_uploads_outlive_the_upload_cache():
    # A recorded CUDA graph reads its coefficients by address, so the
    # program keeps what the capture read: eviction from the 64-entry
    # upload cache must not free a pinned tensor.
    from repro_torch.device import cached_upload, pinned_uploads

    coeffs = np.arange(12, dtype=np.float64).reshape(3, 4) / 7.0
    with pinned_uploads() as held:
        first = cached_upload(coeffs, torch.device("cpu"), torch.float32)
        assert cached_upload(coeffs, torch.device("cpu"), torch.float32) is first
    outside = cached_upload(coeffs + 1.0, torch.device("cpu"), torch.float32)
    assert list(held.values()) == [first]  # one entry per tensor, none after the block
    assert all(t is not outside for t in held.values())
    for i in range(65):  # evicts ``coeffs`` from the cache
        cached_upload(np.full((3, 4), i + 0.5), torch.device("cpu"), torch.float32)
    again = cached_upload(coeffs, torch.device("cpu"), torch.float32)
    assert again is not first  # uploaded anew: the cache had dropped it
    torch.testing.assert_close(held[id(first)], torch.as_tensor(coeffs, dtype=torch.float32),
                               rtol=0, atol=0)


def test_launch_count_api_orders_union_then_step():
    from repro_torch.kernels import cheb_bsr

    cheb_bsr.reset_launch_counts()
    assert cheb_bsr.launch_counts() == (0, 0, 0)
    cheb_bsr.add_launches((3, 20, 2))
    assert cheb_bsr.launch_counts() == (3, 20, 2)
    assert (cheb_bsr.cheb_union_cuda.launches, cheb_bsr.cheb_step_cuda.launches,
            cheb_bsr.cheb_adjoint_union_cuda.launches) == (3, 20, 2)
    cheb_bsr.add_launches((-3, -20, -2))
    assert cheb_bsr.launch_counts() == (0, 0, 0)
    with pytest.raises(ValueError):
        cheb_bsr.add_launches((1,))
    with pytest.raises(ValueError):
        cheb_bsr.add_launches((1, 0))


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
