"""Port parity for the language models: ``repro_torch.models`` and
``repro_torch.configs`` held against ``repro.models`` and
``repro.configs`` on the same numpy inputs.

* Every FULL and SMOKE config (``sensor_gsp``'s ``SensorGSPConfig``
  included) equals the reference's field for field.
* ``init``'s logical spec tree equals the reference's; ``abstract_init``
  (the port builds on the ``meta`` device) gives every FULL config's
  leaves the reference's shapes and dtypes.
* Layers, weights carried from the reference with
  ``interop.lm_params_from_numpy``, within 1e-5: the three norms (the
  layernorm's population variance), rope at fraction 1 and 0.5, naive and
  chunked attention with a window and a softcap, the three FFN
  activations (GeGLU's tanh GeLU), MoE with an overflowing capacity and
  with shared experts (top-k ties to the lower index), Mamba across chunk
  boundaries, mLSTM and sLSTM.
* ``forward`` logits of the 10 LM archs at smoke width within 1e-4
  (absolute, plus 1e-4 of the reference's value). Given the same input,
  each block agrees to ~2e-6; through a random-init stack a difference
  roughly doubles per layer (xLSTM smoke: 2e-6 after the first of 8
  blocks, 1.8e-4 after the last, on logits up to ~5), so the stack's
  tolerance carries a relative part the block tests do not need.
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
from repro.models import mamba as jM
from repro.models import moe as jMOE
from repro.models import sharding as jshard
from repro.models import xlstm as jX
from repro.models.config import ParallelConfig as JPar
from repro_torch import interop
from repro_torch.configs import registry as treg
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tM
from repro_torch.models import moe as tMOE
from repro_torch.models import sharding as tshard
from repro_torch.models import xlstm as tX
from repro_torch.tree import tree_flatten_with_path

LM_ARCHS = [a for a in jreg.ARCH_IDS if a != "sensor_gsp"]
LAYER_TOL, LOGIT_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One multi-threaded ``torch.exp`` before the tests (see
    ``tests/test_torch_core.py``: the first call of a process can stray
    by 1e-4 in a thread's grain on this torch build)."""
    torch.exp(torch.zeros(1 << 16))


def _port(tree):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=tol)


# ------------------------------------------------------------- configs ---


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_config_equals_reference(arch, variant):
    get_j = jreg.get if variant == "full" else jreg.get_smoke
    get_t = treg.get if variant == "full" else treg.get_smoke
    want, got = get_j(arch), get_t(arch)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if hasattr(want, "pdtype"):
        assert str(got.pdtype()) == f"torch.{want.pdtype().name}"
        assert str(got.dtype()) == f"torch.{want.dtype().name}"
        assert (got.repeats, got.head_dim_, got.has_attention, got.pure_full_attention) == (
            want.repeats, want.head_dim_, want.has_attention, want.pure_full_attention)


def test_registry_shapes_and_parallel_defaults_equal_reference():
    from repro.models import config as jconfig

    assert treg.available() == jreg.available()
    assert [dataclasses.asdict(s) for s in tconfig.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in jconfig.ALL_SHAPES]
    assert dataclasses.asdict(tconfig.ParallelConfig()) == dataclasses.asdict(JPar())
    assert treg.get("gemma2-2b") == treg.get("gemma2_2b")  # the reference's name folding


def test_sharding_rules_equal_reference():
    sizes = {"data": 16, "model": 16}
    for kw in ({}, {"fsdp": True}, {"seq_parallel": True, "shard_kv_seq": True},
               {"expert_data_parallel": True}):
        jr = jshard.make_rules(axis_sizes=sizes, **kw)
        tr = tshard.make_rules(axis_sizes=sizes, **kw)
        assert dict(tr.rules) == dict(jr.rules)
        for logical, shape in ((("experts", "d_model", None), (384, 7168, 8)),
                               (("act_kv_batch", "act_kv_seq", "act_kv_heads", None),
                                (1, 32768, 8, 128)),
                               (("vocab", "d_model"), (256000, 2304))):
            assert tr.physical(logical, shape) == tuple(jr.physical(logical, shape))
    x = torch.ones(3)
    assert tshard.constrain(x, tshard.make_rules(axis_sizes=sizes), "act_batch") is x


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_specs_equal_reference(arch):
    cfg_j, cfg_t = jreg.get_smoke(arch), treg.get_smoke(arch)
    _, want = jlm.abstract_init(cfg_j)
    params, got = tlm.init(torch.Generator().manual_seed(0), cfg_t, "cpu")
    assert got == want
    assert tlm.cache_logical_specs(cfg_t) == jlm.cache_logical_specs(cfg_j)
    # one rank-matched spec per param leaf, in jax's leaf order
    leaves = [leaf for _, leaf in tree_flatten_with_path(params)[0]]
    specs = jax.tree.leaves(want, is_leaf=jshard.is_spec)
    assert len(leaves) == len(specs)
    for leaf, spec in zip(leaves, specs):
        assert leaf.ndim == len(spec), (spec, leaf.shape)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_init_matches_reference(arch):
    # FULL configs up to 1 T parameters: the port's tree is on the meta
    # device, so this allocates nothing.
    shapes, _ = jlm.abstract_init(jreg.get(arch))
    params, _ = tlm.abstract_init(treg.get(arch))
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): (tuple(a.shape), a.dtype.name)
            for p, a in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in tree_flatten_with_path(params)[0]}
    assert all(t.device.type == "meta" for _, t in tree_flatten_with_path(params)[0])
    assert got == want


# -------------------------------------------------------------- layers ---


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "rmsnorm_gemma"])
def test_norm_matches_reference(kind):
    r = _rng(0)
    x = (3.0 + 2.0 * r.standard_normal((2, 5, 64))).astype(np.float32)  # off-centre: var matters
    p = {"w": r.standard_normal(64).astype(np.float32),
         "b": r.standard_normal(64).astype(np.float32)}
    if kind != "layernorm":
        p.pop("b")
    want = jL.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), kind)
    got = tL.apply_norm(_port(p), torch.from_numpy(x), kind)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_reference(fraction):
    x = _rng(1).standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.arange(12)
    want = jL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, fraction)
    got = tL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0, fraction)
    _close(got, want, LAYER_TOL)


def _attention_inputs(cfg_j, seed=2, s=20):
    p, _ = jL.init_attention(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    x = (0.5 * _rng(seed).standard_normal((2, s, cfg_j.d_model))).astype(np.float32)
    return p, x


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attention_matches_reference(impl, window):
    # gemma2 smoke: GQA (4 heads over 2), head_dim 32, attention softcap 50
    cfg_j, cfg_t = jreg.get_smoke("gemma2_2b"), treg.get_smoke("gemma2_2b")
    p, x = _attention_inputs(cfg_j)
    pos = np.arange(x.shape[1])
    want, _ = jL.apply_attention(p, jnp.asarray(x), cfg_j, rules=None, positions=jnp.asarray(pos),
                                 window=window, impl=impl, chunk=8)
    got, _ = tL.apply_attention(_port(p), torch.from_numpy(x), cfg_t, rules=None,
                                positions=torch.from_numpy(pos), window=window, impl=impl,
                                chunk=8)
    _close(got, want, LAYER_TOL)


def test_attention_scores_round_in_the_input_dtype():
    # bf16 operands: the contraction's output is rounded to bf16 before
    # the f32 upcast, as the reference's einsum does.
    r = _rng(3)
    q = r.standard_normal((1, 6, 2, 2, 32)).astype(np.float32)
    k = r.standard_normal((1, 9, 2, 32)).astype(np.float32)
    qj, kj = jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    qt, kt = torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16()
    want = np.asarray(jL._gqa_scores(qj, kj, 1.0, None))
    got = tL._gqa_scores(qt, kt, 1.0, None)
    assert got.dtype == torch.float32
    assert torch.equal(got, got.bfloat16().float())  # bf16 values
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0**-7, atol=0)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2"])
def test_dense_ffn_matches_reference(act):
    cfg_j = dataclasses.replace(jreg.get_smoke("llama3_405b"), act=act)
    cfg_t = dataclasses.replace(treg.get_smoke("llama3_405b"), act=act)
    p, _ = jL.init_dense_ffn(jax.random.PRNGKey(4), cfg_j, jnp.float32)
    x = (2.0 * _rng(4).standard_normal((2, 7, cfg_j.d_model))).astype(np.float32)
    want = jL.apply_dense_ffn(p, jnp.asarray(x), act)
    got = tL.apply_dense_ffn(_port(p), torch.from_numpy(x), cfg_t.act)
    _close(got, want, LAYER_TOL)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    got = torch.nn.functional.gelu(x, approximate="tanh")
    _close(got, want, 1e-6)
    assert float((torch.nn.functional.gelu(x) - got).abs().max()) > 1e-4  # the erf form differs


@pytest.mark.parametrize("case", ["overflow", "shared"])
def test_moe_matches_reference(case):
    arch = "deepseek_moe_16b"  # 8 experts top-2, one shared expert
    cfg_j, cfg_t = jreg.get_smoke(arch), treg.get_smoke(arch)
    if case == "overflow":
        # 64 tokens x top-2 into 8 experts of capacity 8: half the pairs drop
        moe_j = dataclasses.replace(cfg_j.moe, n_shared=0, capacity_factor=0.25)
        moe_t = dataclasses.replace(cfg_t.moe, n_shared=0, capacity_factor=0.25)
        cfg_j = dataclasses.replace(cfg_j, moe=moe_j)
        cfg_t = dataclasses.replace(cfg_t, moe=moe_t)
    p, _ = jMOE.init_moe(jax.random.PRNGKey(5), cfg_j, jnp.float32)
    x = _rng(5).standard_normal((2, 32, cfg_j.d_model)).astype(np.float32)
    want, aux_w = jMOE.apply_moe(p, jnp.asarray(x), cfg_j, rules=None)
    got, aux_g = tMOE.apply_moe(_port(p), torch.from_numpy(x), cfg_t, rules=None)
    _close(got, want, LAYER_TOL)
    _close(aux_g, aux_w, LAYER_TOL)
    if case == "overflow":
        probs = torch.softmax(torch.from_numpy(x).reshape(64, -1) @ _port(p)["router"], -1)
        _, idx = tMOE.top_k_lower_index(probs, 2)
        assert idx.reshape(-1).bincount(minlength=8).max() > 8  # some expert overflowed


def test_top_k_ties_take_the_lower_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 3)
    got_v, got_i = tMOE.top_k_lower_index(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_mamba_matches_reference_across_chunks():
    cfg_j, cfg_t = jreg.get_smoke("jamba15_large_398b"), treg.get_smoke("jamba15_large_398b")
    p, _ = jM.init_mamba(jax.random.PRNGKey(6), cfg_j, jnp.float32)
    x = _rng(6).standard_normal((2, 10, cfg_j.d_model)).astype(np.float32)
    # chunk 4 over 10 tokens: two full chunks and a padded one
    want, _ = jM.apply_mamba(p, jnp.asarray(x), cfg_j, rules=None, chunk=4)
    got, _ = tM.apply_mamba(_port(p), torch.from_numpy(x), cfg_t, rules=None, chunk=4)
    _close(got, want, LAYER_TOL)
    # and one decode step from a carried state
    st = jM.make_mamba_state(cfg_j, 2, jnp.float32)
    st = {"conv": jnp.asarray(_rng(7).standard_normal(st["conv"].shape), jnp.float32),
          "ssm": jnp.asarray(_rng(8).standard_normal(st["ssm"].shape), jnp.float32)}
    want, st_w = jM.apply_mamba(p, jnp.asarray(x[:, :1]), cfg_j, rules=None, state=st)
    st_t = interop.cache_from_numpy(jax.tree.map(np.asarray, st), "cpu")
    got, st_g = tM.apply_mamba(_port(p), torch.from_numpy(x[:, :1]), cfg_t, rules=None,
                               state=st_t)
    _close(got, want, LAYER_TOL)
    for key in st_w:
        _close(st_g[key], st_w[key], LAYER_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_match_reference(kind):
    cfg_j, cfg_t = jreg.get_smoke("xlstm_350m"), treg.get_smoke("xlstm_350m")
    x = _rng(9).standard_normal((2, 10, cfg_j.d_model)).astype(np.float32)
    if kind == "mlstm":
        p, _ = jX.init_mlstm(jax.random.PRNGKey(9), cfg_j, jnp.float32)
        want, _ = jX.apply_mlstm(p, jnp.asarray(x), cfg_j, rules=None, chunk=4)
        got, _ = tX.apply_mlstm(_port(p), torch.from_numpy(x), cfg_t, rules=None, chunk=4)
    else:
        p, _ = jX.init_slstm(jax.random.PRNGKey(9), cfg_j, jnp.float32)
        want, _ = jX.apply_slstm(p, jnp.asarray(x), cfg_j, rules=None)
        got, _ = tX.apply_slstm(_port(p), torch.from_numpy(x), cfg_t, rules=None)
    _close(got, want, LAYER_TOL)


# ------------------------------------------------------------- forward ---


def _batch(cfg, seed, b=2, s=32):
    r = _rng(seed)
    tokens = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = None
    if cfg.family in ("vlm", "audio"):
        extra = (0.02 * r.standard_normal((b, 8, cfg.d_model))).astype(np.float32)
    return tokens, extra


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_logits_match_reference(arch):
    cfg_j, cfg_t = jreg.get_smoke(arch), treg.get_smoke(arch)
    params, _ = jlm.init(jax.random.PRNGKey(0), cfg_j)
    tokens, extra = _batch(cfg_j, 10)
    par_j = JPar(attn_impl="naive", remat="none")
    want, aux_w = jlm.forward(params, jnp.asarray(tokens), cfg_j, par_j,
                              extra_embeds=None if extra is None else jnp.asarray(extra))
    got, aux_g = tlm.forward(_port(params), torch.from_numpy(tokens), cfg_t,
                             tconfig.ParallelConfig(attn_impl="naive", remat="none"),
                             extra_embeds=None if extra is None else torch.from_numpy(extra))
    assert got.shape == (2, 32, cfg_t.vocab_size) and bool(torch.isfinite(got).all())
    _close(got, want, LOGIT_TOL, LOGIT_TOL)
    _close(aux_g, aux_w, LOGIT_TOL, LOGIT_TOL)
    # the forward-only loss, at the same logits
    labels = _rng(11).integers(-1, cfg_j.vocab_size, tokens.shape).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    if extra is not None:
        batch_j["extra_embeds"], batch_t["extra_embeds"] = jnp.asarray(extra), torch.from_numpy(extra)
    loss_w, m_w = jlm.loss_fn(params, batch_j, cfg_j, par_j)
    loss_g, m_g = tlm.loss_fn(_port(params), batch_t, cfg_t,
                              tconfig.ParallelConfig(attn_impl="naive", remat="none"))
    _close(loss_g, loss_w, LOGIT_TOL, LOGIT_TOL)
    assert float(m_g["tokens"]) == float(m_w["tokens"])
