"""Port parity for the LM backward pass: ``repro_torch.models.lm.loss_fn``
differentiated by torch autograd (``repro_torch.train.value_and_grad``)
held against ``jax.value_and_grad`` of ``repro.models.lm.loss_fn`` on the
same numpy params and batch.

* The ten LM archs at smoke width: loss within 1e-5; every gradient leaf
  within 1e-5 + 1e-4 max|g| (xLSTM's stacked f32 rounding also gets
  1e-4 |g| per entry, as its logits do in ``tests/test_torch_models.py``).
  The params are drawn by the port (``lm.init`` on a torch generator) and
  carried to the reference as numpy, which skips the reference's init.
  The reference is jitted, as its train steps are.
* ``remat="block"`` (``torch.utils.checkpoint`` per repeat group) equals
  ``remat="none"`` within 1e-6.
* Microbatches: 4 microbatches against the full batch at the reference's
  ``test_microbatched_grads_match_full_batch`` tolerances (params rtol
  2e-4, atol 2e-5; loss rel 2e-4).
* MoE with an overflowing capacity: the port's ``index_put`` dispatch
  gives a dropped token its sentinel row's (zero) gradient, as JAX's
  scatter-set gives an overwritten update none; grads within 1e-5.
* Chunked attention with a window shorter than the sequence and padded
  keys: gradients finite, equal to naive attention's and to the
  reference's chunked gradients within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import moe as jMOE
from repro.models.config import ParallelConfig as JPar
from repro_torch import interop
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tMOE
from repro_torch.models.config import ParallelConfig as TPar
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves, tree_map

LM_ARCHS = [a for a in jreg.ARCH_IDS if a != "sensor_gsp"]
LOSS_TOL, GRAD_TOL, GRAD_REL = 1e-5, 1e-5, 1e-4
REMAT_TOL, LAYER_TOL = 1e-6, 1e-5


def _jnp_copy(a):
    """A jax array of its own (``jnp.asarray`` of a CPU tensor's numpy view
    can share the tensor's memory, which a donated step then rewrites)."""
    return jnp.asarray(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its steps are many small eager
    ops, and under the suite's parallel workers torch's thread teams
    oversubscribe the cores (a 3 s ``Trainer`` test took minutes).
    Single-threaded, the first ``torch.exp`` needs no warm-up either
    (``tests/test_torch_core.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return interop.cache_to_numpy(tree)


def _jax_tree(tree):
    return jax.tree.map(_jnp_copy, _np_tree(tree))


def _batch(cfg, seed, b=2, s=32):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": r.integers(-1, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family in ("vlm", "audio"):
        batch["extra_embeds"] = (0.02 * r.standard_normal((b, 8, cfg.d_model))).astype(np.float32)
    return batch


def _assert_grads_close(got, want, rel=GRAD_REL, atol=GRAD_TOL, elem_rel=0.0):
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        a = a.detach().float().numpy()
        assert np.isfinite(a).all()
        tol = atol + rel * np.abs(b).max() + elem_rel * np.abs(b)
        assert (np.abs(a - b) <= tol).all(), float(np.abs(a - b).max())


def _port_params(cfg, seed=0):
    params, _ = tlm.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    return params


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg_j, cfg_t = jreg.get_smoke(arch), treg.get_smoke(arch)
    params = _port_params(cfg_t)
    batch = _batch(cfg_j, 10)
    par_j = JPar(attn_impl="naive", remat="none")
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, cfg_j, par_j), has_aux=True))
    (loss_w, _), grads_w = vg(_jax_tree(params), jax.tree.map(jnp.asarray, batch))

    par_t = TPar(attn_impl="naive", remat="none")
    loss, _, grads = value_and_grad(lambda p, b: tlm.loss_fn(p, b, cfg_t, par_t),
                                    params, interop.batch_from_numpy(batch, "cpu"))
    assert abs(float(loss) - float(loss_w)) <= LOSS_TOL
    _assert_grads_close(grads, grads_w, elem_rel=GRAD_REL if arch == "xlstm_350m" else 0.0)
    # the gradient tree has the params' structure and dtypes; params untouched
    for g, p in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.dtype == p.dtype and not p.requires_grad and g.grad_fn is None


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_block_equals_none(arch):
    cfg = treg.get_smoke(arch)
    params = _port_params(cfg, seed=1)
    batch = interop.batch_from_numpy(_batch(cfg, 11), "cpu")
    out = {}
    for remat in ("none", "block"):
        par = TPar(attn_impl="chunked", attn_chunk=8, remat=remat)
        out[remat] = value_and_grad(lambda p, b: tlm.loss_fn(p, b, cfg, par), params, batch)
    assert abs(float(out["block"][0]) - float(out["none"][0])) <= REMAT_TOL
    for a, b in zip(tree_leaves(out["block"][2]), tree_leaves(out["none"][2])):
        torch.testing.assert_close(a, b, rtol=0, atol=REMAT_TOL)


def test_remat_block_checkpoints_each_group(monkeypatch):
    calls = []
    real = tlm.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(tlm, "checkpoint", counting)
    cfg = treg.get_smoke("gemma2_2b")
    params = _port_params(cfg)
    batch = interop.batch_from_numpy(_batch(cfg, 12), "cpu")
    par = TPar(attn_impl="naive", remat="block")
    value_and_grad(lambda p, b: tlm.loss_fn(p, b, cfg, par), params, batch)
    assert calls == [False] * cfg.repeats
    with torch.no_grad():  # serving does not checkpoint
        tlm.loss_fn(params, batch, cfg, par)
    assert len(calls) == cfg.repeats


def test_stacked_leaves_are_unbound_once_per_forward():
    # each stacked block leaf reaches the groups through ONE unbind (whose
    # backward stacks the groups' gradients), not a t[r] select per group
    # (whose backward writes a zero tensor the size of the whole stack)
    cfg = treg.get_smoke("llama3_405b")
    params = _port_params(cfg)
    n_stacked = len(tree_leaves(params["blocks"]))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = tlm.loss_fn(params, interop.batch_from_numpy(_batch(cfg, 13), "cpu"), cfg,
                          TPar(attn_impl="naive", remat="none"))
    seen, stack, names = set(), [loss.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(nxt for nxt, _ in node.next_functions)
    assert names.count("UnbindBackward0") == n_stacked > 0
    assert all(t.grad is None for t in leaves)


def test_microbatched_step_matches_full_batch():
    # tests/test_substrate.py::test_microbatched_grads_match_full_batch
    cfg = treg.get_smoke("llama3_405b")
    optc = AdamWConfig(peak_lr=1e-3)
    params = _port_params(cfg, seed=1)
    r = np.random.default_rng(14)
    batch = interop.batch_from_numpy(
        {"tokens": r.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32),
         "labels": r.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)}, "cpu")
    outs = {}
    for n_micro in (1, 4):
        par = TPar(attn_impl="naive", remat="none", microbatches=n_micro)
        p2, _, m = make_train_step(cfg, par, optc)(params, init_opt_state(params, optc), batch)
        outs[n_micro] = (tree_leaves(p2)[0].numpy(), float(m["loss"]))
    np.testing.assert_allclose(outs[1][0], outs[4][0], rtol=2e-4, atol=2e-5)
    assert outs[1][1] == pytest.approx(outs[4][1], rel=2e-4)


def test_moe_overflow_grads_match_reference():
    # the overflow case of tests/test_torch_models.py::test_moe_matches_reference:
    # 64 tokens x top-2 into 8 experts of capacity 8, half the pairs drop
    arch = "deepseek_moe_16b"
    cfg_j, cfg_t = jreg.get_smoke(arch), treg.get_smoke(arch)
    cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe, n_shared=0,
                                                               capacity_factor=0.25))
    cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe, n_shared=0,
                                                               capacity_factor=0.25))
    p, _ = jMOE.init_moe(jax.random.PRNGKey(5), cfg_j, jnp.float32)
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 32, cfg_j.d_model)).astype(np.float32)
    w = r.standard_normal((2, 32, cfg_j.d_model)).astype(np.float32)

    def f_ref(p, x):
        out, aux = jMOE.apply_moe(p, x, cfg_j, rules=None)
        return jnp.sum(out * w) + aux

    want_p, want_x = jax.jit(jax.grad(f_ref, argnums=(0, 1)))(p, jnp.asarray(x))

    def f_port(p, x):
        out, aux = tMOE.apply_moe(p, x, cfg_t, rules=None)
        return torch.sum(out * torch.from_numpy(w)) + aux, {}

    _, _, (got_p, got_x) = value_and_grad(
        lambda t, _: f_port(t[0], t[1]),
        (interop.lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), torch.from_numpy(x)),
        None)
    _assert_grads_close(got_p, want_p, rel=0.0, atol=LAYER_TOL)
    _assert_grads_close(got_x, want_x, rel=0.0, atol=LAYER_TOL)
    # dropped tokens: some (token, slot) pairs were sent to the sentinel row
    probs = torch.softmax(torch.from_numpy(x).reshape(64, -1) @ got_p["router"].new_tensor(
        np.asarray(p["router"])), -1)
    _, idx = tMOE.top_k_lower_index(probs, 2)
    assert idx.reshape(-1).bincount(minlength=8).max() > 8


@pytest.mark.parametrize("window", [5, None])
def test_chunked_attention_grads_match_naive_and_reference(window):
    # 20 positions in chunks of 8: the last chunk holds 4 padded keys (at
    # position 2**30), and with window 5 whole chunks are masked for a row
    cfg_j, cfg_t = jreg.get_smoke("gemma2_2b"), treg.get_smoke("gemma2_2b")
    p, _ = jL.init_attention(jax.random.PRNGKey(2), cfg_j, jnp.float32)
    r = np.random.default_rng(2)
    x = (0.5 * r.standard_normal((2, 20, cfg_j.d_model))).astype(np.float32)
    w = r.standard_normal((2, 20, cfg_j.d_model)).astype(np.float32)
    pos = np.arange(20)

    def f_ref(p, x):
        out, _ = jL.apply_attention(p, x, cfg_j, rules=None, positions=jnp.asarray(pos),
                                    window=window, impl="chunked", chunk=8)
        return jnp.sum(out * w)

    want = jax.jit(jax.grad(f_ref, argnums=(0, 1)))(p, jnp.asarray(x))
    got = {}
    for impl in ("chunked", "naive"):
        def f_port(t, _, impl=impl):
            out, _ = tL.apply_attention(t[0], t[1], cfg_t, rules=None,
                                        positions=torch.from_numpy(pos), window=window,
                                        impl=impl, chunk=8)
            return torch.sum(out * torch.from_numpy(w)), {}

        _, _, got[impl] = value_and_grad(
            f_port, (interop.lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu"),
                     torch.from_numpy(x)), None)
    for impl in ("chunked", "naive"):
        _assert_grads_close(got[impl][0], want[0], rel=0.0, atol=LAYER_TOL)
        _assert_grads_close(got[impl][1], want[1], rel=0.0, atol=LAYER_TOL)
    for a, b in zip(tree_leaves(got["chunked"]), tree_leaves(got["naive"])):
        torch.testing.assert_close(a, b, rtol=0, atol=LAYER_TOL)


def test_value_and_grad_gives_zeros_for_an_unused_leaf():
    params = {"a": torch.ones(3), "b": torch.ones(2)}
    loss, metrics, grads = value_and_grad(lambda p, _: (p["a"].sum() * 2, {"n": 1}), params, None)
    assert float(loss) == 6.0 and metrics == {"n": 1}
    assert torch.equal(grads["a"], torch.full((3,), 2.0)) and torch.equal(grads["b"], torch.zeros(2))
    assert tree_map(lambda t: t.requires_grad, params) == {"a": False, "b": False}
