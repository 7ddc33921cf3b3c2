"""Carry state across from the JAX package as plain numpy arrays.

The reference draws its graphs and weights from ``jax.random``; these
helpers let the same drawn graph, Block-ELL operands, coefficients, joint
(multi-shift) filters, solver problems, LM parameters, optimiser states,
batches and LM caches enter
the port, so tests can feed identical inputs to both packages.
Nothing here imports the reference: callers pass numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import SensorGraph
from repro_torch.device import resolve_device
from repro_torch.filters import GraphFilter
from repro_torch.kernels.ref import BlockEll
from repro_torch.solvers import GramProblem, LassoProblem
from repro_torch.tree import tree_map

__all__ = [
    "sensor_graph_from_numpy",
    "block_ell_from_numpy",
    "filter_from_numpy",
    "joint_filter_from_numpy",
    "problem_from_numpy",
    "lm_params_from_numpy",
    "opt_state_from_numpy",
    "batch_from_numpy",
    "cache_from_numpy",
    "cache_to_numpy",
]


def sensor_graph_from_numpy(
    adjacency, coords=None, device: str | torch.device | None = None
) -> SensorGraph:
    """A float32 ``SensorGraph`` on ``device`` from (N, N) and (N, d) arrays."""
    dev = resolve_device(device)
    a = np.asarray(adjacency)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"adjacency must be square, got {a.shape}")
    c = None
    if coords is not None:
        c = torch.as_tensor(np.asarray(coords), device=dev).to(torch.float32)
        if c.shape[0] != a.shape[0]:
            raise ValueError(f"coords have {c.shape[0]} rows, adjacency {a.shape[0]}")
    return SensorGraph(torch.as_tensor(a, device=dev).to(torch.float32), c)


def block_ell_from_numpy(
    blocks, cols, device: str | torch.device | None = None
) -> BlockEll:
    """A ``BlockEll`` on ``device``; tiles keep their float dtype (float64
    becomes float32), columns become int32 and are range-checked."""
    dev = resolve_device(device)
    b = np.asarray(blocks)
    dtype = torch.float32 if b.dtype == np.float64 else None
    bt = torch.as_tensor(b, device=dev)
    return BlockEll(
        bt.to(dtype) if dtype else bt,
        torch.as_tensor(np.asarray(cols, dtype=np.int32), device=dev),
    )


def filter_from_numpy(coeffs, lmax: float, graph: SensorGraph | None = None) -> GraphFilter:
    """A ``GraphFilter`` from (eta, M+1) coefficients and ``lmax``, bound
    to ``graph`` (whose device the filter's backends use)."""
    return GraphFilter.from_coefficients(np.asarray(coeffs, np.float64), float(lmax), graph=graph)


def joint_filter_from_numpy(
    adjacencies, coords, coeffs, lmaxes, device: str | torch.device | None = None
) -> GraphFilter:
    """A multi-shift ``GraphFilter`` from the reference's arrays: one
    (N, N) adjacency per shift (all sharing the (N, d) ``coords``), the
    joint (eta, M_1+1, ..., M_R+1) coefficients and the per-shift lmaxes.
    The shift graphs are float32 ``SensorGraph`` s on ``device``."""
    shifts = [sensor_graph_from_numpy(a, coords, device) for a in adjacencies]
    return GraphFilter.from_shifts(
        shifts, np.asarray(coeffs, np.float64), lmaxes=[float(v) for v in lmaxes]
    )


def problem_from_numpy(
    coeffs,
    lmax: float,
    graph: SensorGraph,
    *,
    y=None,
    mu=1.0,
    step: float | None = None,
    b=None,
    reg: float = 0.0,
) -> LassoProblem | GramProblem:
    """The port's solver problem from a reference problem's arrays.

    Pass ``y`` (with ``mu`` and ``step``) for a ``LassoProblem`` or ``b``
    (with ``reg``) for a ``GramProblem``. The filter comes from
    ``filter_from_numpy(coeffs, lmax, graph)``; signals, and a
    non-scalar ``mu``, are placed on ``graph``'s device as float32.
    """
    if (y is None) == (b is None):
        raise ValueError("pass exactly one of y= (lasso) or b= (gram)")
    filt = filter_from_numpy(coeffs, lmax, graph)

    def tensor(x):
        return torch.as_tensor(np.asarray(x), device=graph.device).to(torch.float32)

    if y is not None:
        mu_t = float(mu) if np.ndim(mu) == 0 else tensor(mu)
        return LassoProblem(filt=filt, y=tensor(y), mu=mu_t, step=step)
    return GramProblem(filt=filt, b=tensor(b), reg=float(reg))


def _tensor_from_numpy(a, device: torch.device, dtype: torch.dtype | None) -> torch.Tensor:
    """One leaf: a ``bfloat16`` array (an ``ml_dtypes`` array, recognised
    by its dtype's name) is carried bit for bit through a ``uint16`` view;
    ``dtype``, if given, recasts floating leaves."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def lm_params_from_numpy(tree, device: str | torch.device | None = None,
                         dtype: torch.dtype | None = None):
    """The port's LM params tree from the reference's, given with numpy
    leaves (``jax.tree.map(np.asarray, params)``): the same dicts, lists
    and tuples, each leaf a tensor on ``device`` (default ``cuda``). bf16
    leaves keep their bits; ``dtype`` recasts every floating leaf."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor_from_numpy(a, dev, dtype), tree)


def opt_state_from_numpy(tree, device: str | torch.device | None = None):
    """A reference AdamW state (``{"m", "v", "step"}``, numpy leaves) as
    the port's on ``device``: bf16 moments keep their bits, ``step`` stays
    int32."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor_from_numpy(a, dev, None), tree)


def batch_from_numpy(batch: dict, device: str | torch.device | None = None) -> dict:
    """A reference batch (``tokens``, ``labels``, maybe ``extra_embeds``;
    numpy arrays) as tensors on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return {k: _tensor_from_numpy(v, dev, None) for k, v in batch.items()}


def cache_from_numpy(tree, device: str | torch.device | None = None):
    """A reference LM cache (numpy leaves) as the port's cache on
    ``device``; ``len`` and ``pos`` stay int32."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor_from_numpy(a, dev, None), tree)


def cache_to_numpy(tree):
    """The port's cache (or any tree of tensors) with numpy leaves on the
    host, for comparison with the reference's: bf16 leaves come back as
    float32 (exactly), everything else in its own dtype."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)
