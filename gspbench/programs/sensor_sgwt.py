"""The sensor program: ``repro_torch``'s sensor graph and SGWT filter.

A configuration that names ``"program": "sensor_sgwt"`` runs here. Set-up
draws the deployment's sensors from the configuration's ``graph_seed`` (one
field, whose tiling sets the work), the inputs from the run's seed,
builds the program (``program.build``) and warms up the traffic kind's
driver (``drivers.KINDS``). The judge rebuilds the eq. 1 Laplacian and the
SGWT coefficients from the positions and holds the sampled answers to the
float64 reference (``reference/``); the per-layer readers get the
Laplacian's nonzeros. The reference Laplacian is built once per run, at
its first use after the window.
"""

from __future__ import annotations

import functools
import time

import torch

from gspbench import drivers, loadgen, program
from gspbench.reference import cheb
from gspbench.reference.graph import sensor_laplacian

KINDS = drivers.KINDS


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Inputs:
    """The sensors' positions, and the reference Laplacian built from them
    at its first use."""

    def __init__(self, config: dict, coords: torch.Tensor):
        self.config, self.coords = config, coords

    @functools.cached_property
    def lap(self):
        sigma, kappa = program.scaled_kernel(self.config)
        return sensor_laplacian(self.coords, sigma, kappa)


def start(cell, seed: int, device: torch.device):
    """(inputs, program, driver, seconds per stage: ``positions_s``
    (with the device's first use), ``prep_s``, ``warm_up_s``)."""
    t0 = time.perf_counter()
    placement = torch.Generator(device=device).manual_seed(cell.config["graph_seed"])
    coords = loadgen.sensor_positions(placement, cell.config["n_vertices"], device)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    _sync(device)
    t_prep = time.perf_counter()
    prog = program.build(cell.config, coords)
    _sync(device)
    t_driver = time.perf_counter()
    driver = KINDS[cell.traffic["kind"]](prog, cell.traffic, seed, gen)
    driver.warm_up()
    stages = {"positions_s": t_prep - t0, "prep_s": t_driver - t_prep,
              "warm_up_s": time.perf_counter() - t_driver}
    return Inputs(cell.config, coords), prog, driver, stages


def context(cell, inputs: Inputs) -> dict:
    return {"nnz": inputs.lap.nnz}


def judge(cell, inputs: Inputs, driver, samples, precision: str) -> dict:
    """The numbers compared: per check, the worst relative error of the
    sampled answers (``samples``: (check, key, answer)) against the float64
    reference. ``precision="tf32"`` judges the control, the reference in
    float32 with TF32 Laplacian products, in the answers' place."""
    config, lap = cell.config, inputs.lap
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


def tiny(cell) -> None:
    """The cell shrunk in place for the CPU tests: N = 384, F = 8, FISTA-4,
    a light serving load and short trace slices."""
    cell.config["n_vertices"] = 384
    t = cell.traffic
    t["trace_s"] = 0.2
    if "panel_width" in t:
        t["panel_width"] = 8
    if t["kind"] == "lasso_closed":
        t["n_iters"] = 4
    if t["kind"] == "serve_open":
        t.update(rate=100.0, max_panel=16, frame_streams=4, samples=[6, 3, 2],
                 lane_mix=[0.6, 0.2, 0.2])
