"""The system under test: ``repro_torch``'s sensor graph and SGWT filter.

``build`` runs the program's own set-up for a configuration: the eq. 1
graph from the benchmark's positions (``gaussian_kernel_weights``), its
lambda-max rule, the SGWT bank's coefficients (``GraphFilter.from_multipliers``)
and the backend's prepared operands (``prepare_backend``). The benchmark
hands it the positions and reads nothing back but the filter.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Program", "build", "scaled_kernel"]


@dataclasses.dataclass
class Program:
    coords: torch.Tensor
    filt: object  # repro_torch.filters.GraphFilter
    backend: str
    opts: dict

    @property
    def n(self) -> int:
        return self.coords.shape[0]

    @property
    def eta(self) -> int:
        return self.filt.eta

    @property
    def order(self) -> int:
        return self.filt.order

    def apply(self, f):
        return self.filt.apply(f, backend=self.backend, **self.opts)

    def adjoint(self, a):
        return self.filt.adjoint(a, backend=self.backend, **self.opts)


def scaled_kernel(config: dict) -> tuple[float, float]:
    """(sigma, kappa) of eq. 1 at the configuration's N: the paper's values
    at ``paper_n`` sensors times ``sqrt(paper_n / N)``, which keeps the
    paper's mean degree."""
    scale = math.sqrt(config["paper_n"] / config["n_vertices"])
    return config["paper_sigma"] * scale, config["paper_kappa"] * scale


def build(config: dict, coords: torch.Tensor) -> Program:
    from repro_torch.core import multipliers
    from repro_torch.core.graph import SensorGraph, gaussian_kernel_weights
    from repro_torch.filters import GraphFilter

    sigma, kappa = scaled_kernel(config)
    graph = SensorGraph(gaussian_kernel_weights(coords, sigma, kappa), coords)
    lmax = float(graph.lmax_bound())
    bank = multipliers.sgwt_filter_bank(lmax, config["n_scales"], config["sgwt_k"])
    filt = GraphFilter.from_multipliers(bank, config["order"], graph=graph, lmax=lmax)
    opts = {"block_size": config["block_size"]}
    filt.prepare_backend(config["backend"], **opts)
    return Program(coords=coords, filt=filt, backend=config["backend"], opts=opts)
