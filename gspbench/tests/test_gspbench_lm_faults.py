"""A run of the LM sessions program with its served path broken underneath
comes out not correct.

The run skips the look for a card and drives the rest on the CPU at the
program's test size (``lm_sessions.tiny``), once per fault:

* ``perturbed_logit``: one logit of every answer position is moved by
  half the largest logit's magnitude where ``ServeEngine.turn`` hands the
  logits back;
* ``dropped_token``: in every MoE call the last token of each session
  row loses its routed experts (its gates are zeroed) and keeps the
  shared experts, as a token that each chosen expert's capacity turns
  away does in the port's capacity path;
* ``skipped_rewind``: ``lm.rewind`` does nothing (the engine is given
  room for the turns to pile up), so each turn runs on after the
  previous turn's question and answer instead of the document's end.
"""

import time

import pytest
import torch

from gspbench import bench

from conftest import ROOT

LM_CELLS = [w["name"] for w in bench.load_spec(ROOT)["workloads"]
            if bench.find_cell(bench.load_spec(ROOT), w["name"]).config["program"]
            == "lm_sessions"]


def _perturbed_logit(monkeypatch, program):
    real = program.ServeEngine.turn

    def turn(self, questions, n):
        ids, logits = real(self, questions, n)
        logits = logits.clone()
        logits[..., 0] += 0.5 * logits.abs().max()
        return ids, logits

    monkeypatch.setattr(program.ServeEngine, "turn", turn)


def _dropped_token(monkeypatch, program):
    from repro_torch.models import moe

    real_apply, real_experts = moe.apply_moe, moe._dropless_experts
    row_tokens = [1]

    def apply_moe(p, x, cfg, **kw):
        row_tokens[0] = x.shape[1]
        return real_apply(p, x, cfg, **kw)

    def dropless_experts(p, xf, gate, idx, e):
        gate = gate.clone()
        gate.view(-1, row_tokens[0], gate.shape[-1])[:, -1] = 0.0
        return real_experts(p, xf, gate, idx, e)

    monkeypatch.setattr(moe, "apply_moe", apply_moe)
    monkeypatch.setattr(moe, "_dropless_experts", dropless_experts)


def _skipped_rewind(monkeypatch, program):
    from repro_torch.models import lm

    class Roomy(program.ServeEngine):
        def __post_init__(self):
            self.s_max += 4096
            super().__post_init__()

    monkeypatch.setattr(program, "ServeEngine", Roomy)
    monkeypatch.setattr(lm, "rewind", lambda cache, length, cfg: cache)


FAULTS = {"perturbed_logit": _perturbed_logit, "dropped_token": _dropped_token,
          "skipped_rewind": _skipped_rewind}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", LM_CELLS)
def test_fault_is_caught(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch, cell.program)
    res = bench.run_cell(cell, 4242, 0.6, False, torch.device("cpu"), time.perf_counter())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", LM_CELLS)
def test_the_configuration_is_the_registered_one(name):
    """The cell runs ``configs/deepseek_v2_lite.py``'s ``FULL``: every
    published width, as ``model_config`` reads them from the file."""
    from repro_torch.configs import registry

    cell = bench.find_cell(bench.load_spec(ROOT), name)
    assert cell.program.model_config(cell.config) == registry.get(cell.config["name"])
