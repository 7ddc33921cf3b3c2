"""A run with the timed path broken underneath comes out not correct.

The run skips the look for a card and drives the rest on the CPU at a
test size, once per fault the cell can have:

* ``unchanged_step``: each FISTA step returns its state unchanged (the
  lasso cell and the serving solve lane);
* ``half_batch``: the union apply leaves out half of the panel's columns;
* ``altered_answer``: one entry of every union apply's output is altered
  where the kernel produces it.

The cells run on one card, so no exchange between cards can be left out.
"""

import time

import pytest
import torch

from gspbench import bench

from test_gspbench_rehearsal import KIND_CELLS


def _unchanged_step(monkeypatch):
    from repro_torch.solvers import iterative

    real = iterative._LASSO_MACHINES["fista"]

    def machine(*args):
        step, init, final = real(*args)

        def frozen(state):
            _, (trace, stop) = step(state)
            return state, (trace, stop)

        return frozen, init, final

    monkeypatch.setitem(iterative._LASSO_MACHINES, "fista", machine)


def _union_wrapper(monkeypatch, change):
    from repro_torch.filters.backends import BsrBackend

    real = BsrBackend._union_apply

    def wrapped(bell, fp, c, lmax, **kw):
        return change(real(bell, fp, c, lmax, **kw), fp)

    monkeypatch.setattr(BsrBackend, "_union_apply", staticmethod(wrapped))


def _half_batch(monkeypatch):
    def change(out, fp):
        keep = torch.zeros_like(out)
        half = max(out.shape[-1] // 2, 1)
        keep[..., :half] = out[..., :half]
        return keep

    _union_wrapper(monkeypatch, change)


def _altered_answer(monkeypatch):
    def change(out, fp):
        out = out.clone()
        out[0, 0, 0] += 1e-2 * out.abs().max()
        return out

    _union_wrapper(monkeypatch, change)


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}
APPLIES = {"apply_closed": ("half_batch", "altered_answer"),
           "lasso_closed": ("unchanged_step", "half_batch", "altered_answer"),
           "serve_open": ("unchanged_step", "half_batch", "altered_answer")}
CASES = [(KIND_CELLS[kind], fault) for kind, faults in APPLIES.items() for fault in faults]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch)
    res = bench.run_cell(cell, 4242, 0.6, False, torch.device("cpu"), time.perf_counter())
    assert not res["correct"], res["checks"]
