"""Iteration engine for the port's solver layer.

Mirrors ``repro/solvers/loops.py``. Every solver is a *step function*
``state -> (state, (trace, stop))``: ``trace`` is the value recorded into
the history (objective, residual norm) and ``stop`` the scalar the
tolerance test consumes. In torch every loop is one host loop
(:func:`run_loop`); what the backend's ``traceable`` capability selects
is which of the reference's engines its rounding reproduces:

* traceable, no tolerance — the reference's ``lax.scan``: exactly
  ``n_iters`` steps, each trace kept on the device as float32 and copied
  to the host once at the end;
* traceable with a tolerance — the reference's ``lax.while_loop``: the
  history is float32, ``stop`` is rounded to float32 and compared with
  the float32 ``tol`` (the reference's weakly typed ``stop > tol``); the
  test reads ``stop`` on the host, one device synchronisation per
  iteration;
* non-traceable — the reference's host loop: float64 traces and a
  float64 ``stop <= tol`` test.

Histories are returned as float64 numpy arrays in every case.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.telemetry import span

__all__ = ["iterate"]

StepFn = Callable[[Any], Tuple[Any, Tuple[torch.Tensor, torch.Tensor]]]


def iterate(
    step: StepFn,
    init: Any,
    *,
    n_iters: int,
    tol: float | None,
    traceable: bool,
    method: str = "",
) -> tuple[Any, np.ndarray, int, bool]:
    """Drive ``step`` for up to ``n_iters`` iterations.

    Parameters
    ----------
    step : callable
        ``state -> (state, (trace, stop))`` with 0-d tensor ``trace`` and
        ``stop``.
    init : object
        Initial state.
    n_iters : int
        Iteration budget (the exact count when ``tol`` is None).
    tol : float, optional
        Early-stop threshold on ``stop``; None means a fixed-count loop.
    traceable : bool
        The backend's ``traceable`` capability (see the module docstring).
    method : str
        The solver's name, an attribute of each ``solver.iteration`` span.

    Returns
    -------
    (state, history, iterations, converged)
        ``history`` is a float64 numpy array of the recorded traces, one
        per executed iteration. ``converged`` is True when the tolerance
        fired, or when no tolerance was requested and the budget ran.
    """
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    if n_iters == 0:
        return init, np.zeros((0,), np.float64), 0, tol is None

    state, traces, converged = run_loop(step, init, n_iters, tol, f32=traceable, method=method)
    if traceable:
        history = stacked_f32(traces).cpu().numpy().astype(np.float64)
    else:
        history = np.asarray([float(t) for t in traces], np.float64)
    return state, history, len(traces), converged


def run_loop(step, init, n_iters: int, tol: float | None = None, *, f32: bool = True,
             method: str = ""):
    """Run ``step`` up to ``n_iters`` times; returns ``(state, traces,
    converged)`` with the traces as the step gave them.

    With ``tol`` each iteration reads ``stop`` on the host and ends the
    loop once ``stop <= tol``; ``f32`` rounds ``stop`` and ``tol`` to
    float32 first, as the reference's ``while_loop`` compares them.
    Without ``tol`` nothing is read back, so the traces stay on the device.
    Each step runs inside a ``solver.iteration`` span (``method``, index).
    """
    rnd = np.float32 if f32 else np.float64
    state, traces, converged = init, [], tol is None
    for i in range(n_iters):
        with span("solver.iteration", device=True) as sp:
            if sp:
                sp.note(method=method, index=i)
            state, (trace, stop) = step(state)
        traces.append(trace)
        if tol is not None and rnd(float(stop)) <= rnd(tol):
            converged = True
            break
    return state, traces, converged


def stacked_f32(traces: list, device=None) -> torch.Tensor:
    """The traces as one float32 tensor, on their own device (``device``
    for an empty list)."""
    if not traces:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    return torch.stack([torch.as_tensor(t).to(torch.float32) for t in traces])
