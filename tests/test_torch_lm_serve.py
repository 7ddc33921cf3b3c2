"""Port parity for LM serving: ``repro_torch.models.lm``'s ``prefill`` and
``decode_step``, ``repro_torch.serve.ServeEngine``, the serving launcher
``repro_torch.launch.serve`` and the ``repro_torch.serve_lm`` example,
held against ``repro.models.lm`` and ``repro.serve.ServeEngine`` on the
same numpy inputs (weights carried with ``interop.lm_params_from_numpy``).

* ``prefill`` (last logits and the whole cache) and three greedy
  ``decode_step`` s (logits and caches) for gemma2 (local + global
  attention), xlstm (mLSTM + sLSTM states) and jamba (Mamba states, MoE)
  at smoke width within 1e-4 (absolute, plus 1e-4 of the reference's
  value: the stacks amplify f32 rounding, see ``test_torch_models.py``).
* Teacher-forced decode equals the port's own forward, as
  ``tests/test_arch_smoke.py::test_decode_matches_forward`` holds the
  reference, at the reference test's tolerance.
* ``ServeEngine`` greedy ids equal the reference engine's, token for
  token, for gemma2 and codeqwen smoke, with and without ``eos_id``.
* Sampling is deterministic per seed, differs across seeds and stays in
  the vocabulary (its stream is torch's, not jax's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models.config import ParallelConfig as JPar
from repro.serve import ServeEngine as JServeEngine
from repro_torch import interop, serve_lm
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models.config import ParallelConfig as TPar
from repro_torch.serve import ServeEngine, make_decode_step, make_prefill

TOL = 1e-4
JPAR, TPAR = JPar(attn_impl="naive", remat="none"), TPar(attn_impl="naive", remat="none")
SERVE_ARCHS = ["gemma2_2b", "xlstm_350m", "jamba15_large_398b"]


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One multi-threaded ``torch.exp`` before the tests (see
    ``tests/test_torch_core.py``)."""
    torch.exp(torch.zeros(1 << 16))


def _port(tree):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _close_trees(got, want, tol=TOL):
    g_leaves, g_def = jax.tree.flatten(interop.cache_to_numpy(got))
    w_leaves, w_def = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, tol)


@pytest.fixture(scope="module", params=SERVE_ARCHS)
def served(request):
    """The reference's prefill and three greedy decode steps for one arch:
    weights, prompt, and per step (token in, logits, cache) as numpy."""
    arch = request.param
    cfg = jreg.get_smoke(arch)
    params, _ = jlm.init(jax.random.PRNGKey(1), cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    logits, cache = jlm.prefill(params, jnp.asarray(prompt), cfg, JPAR, s_max=12)
    record = {"arch": arch, "params": params, "prompt": prompt,
              "prefill": (np.asarray(logits), jax.tree.map(np.asarray, cache)), "steps": []}
    token = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    for _ in range(3):
        logits, cache = jlm.decode_step(params, jnp.asarray(token), cache, cfg, JPAR)
        record["steps"].append((token, np.asarray(logits), jax.tree.map(np.asarray, cache)))
        token = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    return record


def test_prefill_matches_reference(served):
    cfg = treg.get_smoke(served["arch"])
    logits, cache = tlm.prefill(_port(served["params"]), torch.from_numpy(served["prompt"]),
                                cfg, TPAR, s_max=12)
    want_logits, want_cache = served["prefill"]
    assert logits.shape == want_logits.shape
    _close(logits, want_logits)
    _close_trees(cache, want_cache)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].ndim == 0


def test_decode_steps_match_reference(served):
    # starts from the reference's own prefill cache (cache_from_numpy), so
    # each step's input is the reference's
    cfg = treg.get_smoke(served["arch"])
    params = _port(served["params"])
    cache = interop.cache_from_numpy(served["prefill"][1], "cpu")
    k_before = [t.data_ptr() for t in jax.tree.leaves(cache) if t.ndim >= 4]
    for token, want_logits, want_cache in served["steps"]:
        logits, cache = tlm.decode_step(params, torch.from_numpy(token), cache, cfg, TPAR)
        _close(logits, want_logits)
        _close_trees(cache, want_cache)
    # the cache was written in place: the same buffers, no copies
    assert [t.data_ptr() for t in jax.tree.leaves(cache) if t.ndim >= 4] == k_before


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    # the port's own decode against its own forward, as the reference's
    # test_decode_matches_forward holds the reference (its 2e-2)
    cfg = treg.get_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    par = TPar(attn_impl="naive", remat="none", mamba_chunk=4)
    params, _ = tlm.init(torch.Generator().manual_seed(2), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 8)))
    full, _ = tlm.forward(params, tokens, cfg, par)
    cache = tlm.init_cache(cfg, 1, 8, cfg.dtype(), "cpu")
    outs = []
    for t in range(8):
        logits, cache = tlm.decode_step(params, tokens[:, t:t + 1], cache, cfg, par)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=2e-2, atol=2e-2)
    assert int(cache["pos"]) == 8


def test_prefill_then_decode_matches_pure_decode():
    # tests/test_system.py::test_prefill_then_decode_matches_pure_decode, on the port
    cfg = treg.get_smoke("codeqwen15_7b")
    params, _ = tlm.init(torch.Generator().manual_seed(2), cfg, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 6)))
    logits_pf, _ = make_prefill(cfg, TPAR, s_max=12)(params, prompt)
    step = make_decode_step(cfg, TPAR)
    cache = tlm.init_cache(cfg, 1, 12, cfg.dtype(), "cpu")
    for t in range(prompt.shape[1]):
        logits_dec, cache = step(params, prompt[:, t:t + 1], cache)
    _close(logits_pf[:, -1], logits_dec[:, 0], 2e-4)


@pytest.fixture(scope="module", params=["gemma2_2b", "codeqwen15_7b"])
def engines(request):
    """The reference engine and the port's over the same weights."""
    arch = request.param
    cfg_j, cfg_t = jreg.get_smoke(arch), treg.get_smoke(arch)
    params, _ = jlm.init(jax.random.PRNGKey(0), cfg_j)
    ref = JServeEngine(cfg=cfg_j, par=JPAR, params=params, s_max=32)
    port = ServeEngine(cfg=cfg_t, par=TPAR, params=_port(params), s_max=32, device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg_j.vocab_size, (3, 6)).astype(np.int32)
    return ref, port, prompts


def test_serve_engine_greedy_matches_reference(engines):
    ref, port, prompts = engines
    want = ref.generate(prompts, max_new_tokens=8)
    got = port.generate(prompts, max_new_tokens=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.generate(prompts, max_new_tokens=8), got)


def test_serve_engine_eos_matches_reference(engines):
    # eos = row 0's third greedy id: row 0 stops there, the others run on
    # (or stop where they emit it too); ids after a stop are eos
    ref, port, prompts = engines
    eos = int(ref.generate(prompts, max_new_tokens=8)[0, 2])
    want = ref.generate(prompts, max_new_tokens=8, eos_id=eos)
    got = port.generate(prompts, max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()


def test_serve_engine_sampling_is_seeded():
    cfg = treg.get_smoke("gemma2_2b")
    params, _ = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = ServeEngine(cfg=cfg, par=TPAR, params=params, s_max=32, temperature=1.0, device="cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 5)).astype(np.int32)
    a = eng.generate(prompts, max_new_tokens=12, seed=7)
    b = eng.generate(prompts, max_new_tokens=12, seed=7)
    c = eng.generate(prompts, max_new_tokens=12, seed=8)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert a.shape == (4, 12) and ((a >= 0) & (a < cfg.vocab_size)).all()


def test_serve_engine_refuses_params_on_another_device():
    cfg = treg.get_smoke("gemma2_2b")
    params, _ = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="params on"):
        ServeEngine(cfg=cfg, par=TPAR, params=params, device="meta")


def test_serve_launcher_runs_in_process(capsys):
    rec = tlaunch.main(["--arch", "gemma2_2b", "--smoke", "--batch", "2", "--tokens", "4",
                        "--device", "cpu"])
    assert rec["arch"] == "gemma2-2b-smoke" and rec["device"] == "cpu"
    assert np.asarray(rec["tokens"]).shape == (2, 4) and rec["tokens_per_s"] > 0
    assert "tokens_per_s" in capsys.readouterr().out
    # --dryrun hands the cell to ``repro_torch.launch.dryrun.main``
    # (meta tensors, no card), which prints its roofline line
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--arch", "llama3_405b", "--shape", "decode_32k", "--dryrun"])
    assert exc.value.code == 0
    assert "[llama3_405b.decode_32k] trace=" in capsys.readouterr().out


def test_serve_lm_example_runs():
    res = serve_lm.main(device="cpu")
    assert res["greedy"].shape == (4, 16) and res["sampled"].shape == (4, 16)
