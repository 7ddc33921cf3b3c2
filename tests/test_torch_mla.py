"""DeepSeek-V2's block on the port's LM path (``models/mla.py``, the dropless
router in ``models/moe.py``, ``lm.prefill`` / ``extend`` / ``decode_step`` /
``rewind``, ``ServeEngine`` sessions) against the plain float32 reference
the benchmark judges with, ``gspbench/reference/deepseek_v2.py``, loaded by
path. The reference package has no latent attention, so these tests do not
import it.

Everything runs on the CPU in float32 at ``configs/deepseek_v2_lite.py``'s
smoke widths (d 64, 4 heads, latent 32, rope 16, nope 32, v 32, 8 experts
top-3, 2 shared, a dense first layer), on one torch thread. Tolerances,
as max |port - reference| / max |reference|:

* 1e-5 for a whole forward and for the cached paths: both sides are
  float32; the port's absorbed path reassociates the key and value
  products through the latent (``(W_UK^T q) . c`` for ``q . (W_UK c)``) and
  sums keys in chunks, and its experts run batched, which moves the last
  bits only (the readings are 1e-7 to 2e-6);
* the YaRN frequencies and scale to 1e-7 relative: the same float64
  arithmetic rounded to float32 once.
"""

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.configs import registry
from repro_torch.models import lm, mla
from repro_torch.models.config import MoEConfig, ParallelConfig
from repro_torch.models.layers import linear
from repro_torch.serve import ServeEngine
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
PAR = ParallelConfig()


def _load_reference():
    path = ROOT / "gspbench" / "reference" / "deepseek_v2.py"
    spec = importlib.util.spec_from_file_location("deepseek_v2_reference", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


ref = _load_reference()
CFG = registry.get_smoke("deepseek_v2_lite")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hf_config(cfg) -> dict:
    """The reference's view of a port config: a DeepSeek-V2 config.json."""
    m, y, moe = cfg.mla, cfg.mla.rope_scaling, cfg.moe
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "num_hidden_layers": cfg.n_layers, "vocab_size": cfg.vocab_size,
        "kv_lora_rank": m.kv_lora_rank, "qk_nope_head_dim": m.qk_nope_head_dim,
        "qk_rope_head_dim": m.qk_rope_head_dim, "v_head_dim": m.v_head_dim, "q_lora_rank": None,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": {"type": "yarn", "factor": y.factor, "beta_fast": y.beta_fast,
                         "beta_slow": y.beta_slow, "mscale": y.mscale,
                         "mscale_all_dim": y.mscale_all_dim,
                         "original_max_position_embeddings": y.original_max_position},
        "first_k_dense_replace": len(cfg.prefix_layers), "intermediate_size": cfg.dense_ff_override,
        "moe_intermediate_size": moe.d_expert, "n_routed_experts": moe.n_experts,
        "n_shared_experts": moe.n_shared, "num_experts_per_tok": moe.top_k,
        "norm_topk_prob": moe.norm_topk, "routed_scaling_factor": 1.0,
        "scoring_func": "softmax", "topk_method": "greedy", "rms_norm_eps": 1e-6,
    }


def _layers(params, cfg):
    blocks = [params["prefix"][0]] + [tree_map(lambda t, r=r: t[r], params["blocks"][0])
                                      for r in range(cfg.repeats)]
    out = []
    for i, p in enumerate(blocks):
        m, f = p["mix"], p["ffn"]
        w = {"attn_norm": p["norm1"]["w"], "ffn_norm": p["norm2"]["w"], "wq": m["q"]["w"],
             "wkv_a": m["kv_a"]["w"], "kv_norm": m["kv_norm"]["w"], "wkv_b": m["kv_b"]["w"],
             "wo": m["o"]["w"]}
        if i == 0:
            w.update(w_gate=f["wi_gate"]["w"], w_up=f["wi_up"]["w"], w_down=f["wo"]["w"])
        else:
            w.update(router=f["router"], experts_gate=f["wi_gate"], experts_up=f["wi_up"],
                     experts_down=f["wo"], shared_gate=f["shared"]["wi_gate"]["w"],
                     shared_up=f["shared"]["wi_up"]["w"], shared_down=f["shared"]["wo"]["w"])
        out.append(w)
    return out


def reference_logits(params, cfg, tokens, at):
    """The reference's logits (len(at), V) of one sequence under the
    port's weights."""
    layers = _layers(params, cfg)
    top = {"embed": params["embed"]["table"], "final_norm": params["final_norm"]["w"],
           "head": params["embed"]["unembed"]}
    return ref.forward(hf_config(cfg), lambda i: layers[i], top, torch.as_tensor(tokens), at)


def make_params(cfg=CFG, seed=0):
    """Seeded weights with every norm weight moved off 1, so that a
    misplaced norm shows."""
    params, _ = lm.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    blocks = (params["prefix"][0], params["blocks"][0])
    norms = [params["final_norm"], *(b["norm1"] for b in blocks), *(b["norm2"] for b in blocks),
             *(b["mix"]["kv_norm"] for b in blocks)]
    for p in norms:
        p["w"].add_(0.1 * torch.randn(p["w"].shape, generator=gen))
    return params


def rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def tokens(n, seed, vocab=CFG.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, n)


@pytest.fixture(scope="module")
def params():
    return make_params()


# The dropless experts run as one batched product up to
# STATIC_DEPTH_TOKENS (64) tokens, and on exact slices past it.
LENGTHS = [40, 100]


@pytest.mark.parametrize("n", LENGTHS)
def test_forward_equals_reference(params, n):
    seq = tokens(n, 1)
    logits, _ = lm.forward(params, torch.as_tensor(seq)[None], CFG, PAR)
    want = reference_logits(params, CFG, seq, torch.arange(n))
    assert rel(logits[0], want) < TOL


def test_prefill_then_decode_equals_reference(params):
    seq = tokens(36, 2)
    doc, n = 28, 8
    logits, cache = lm.prefill(params, torch.as_tensor(seq[:doc])[None], CFG, PAR, s_max=40)
    got = [logits[0, -1]]
    for t in range(doc, doc + n - 1):
        logits, cache = lm.decode_step(params, torch.as_tensor(seq[t:t + 1])[None], cache, CFG,
                                       PAR)
        got.append(logits[0, 0])
    want = reference_logits(params, CFG, seq[:doc + n - 1], torch.arange(doc - 1, doc + n - 1))
    assert rel(torch.stack(got), want) < TOL
    assert int(cache["pos"]) == doc + n - 1
    assert [int(c["len"]) for c in [cache["prefix"][0]]] == [doc + n - 1]


def test_session_turn_rewind_and_second_turn(params):
    docs = np.stack([tokens(30, 3), tokens(30, 4)])
    q1, q2 = tokens((2, 6), 5), tokens((2, 5), 6)
    eng = ServeEngine(CFG, PAR, params, s_max=30 + 6 + 4, device="cpu")
    sess = eng.open_sessions(docs)
    assert sess.length == 30 and sess.cache["blocks"][0]["latent"].shape == (2, 2, 40, 48)
    ids1, logits1 = eng.turn(q1, 4)
    ids2, logits2 = eng.turn(q2, 4)
    assert ids1.shape == ids2.shape == (2, 4) and logits2.shape == (2, 4, CFG.vocab_size)
    assert int(sess.cache["pos"]) == 30
    for turn_q, ids, logits in ((q1, ids1, logits1), (q2, ids2, logits2)):
        assert (ids == logits.argmax(-1).numpy()).all()
        for s in range(2):
            seq = np.concatenate([docs[s], turn_q[s], ids[s, :-1]])
            q = turn_q.shape[1]
            want = reference_logits(params, CFG, seq, torch.arange(30 + q - 1, 30 + q + 3))
            assert rel(logits[s], want) < TOL


def _forced_onto_expert_zero(params, cfg, j=5, big=50.0):
    """Weights under which every token routes to expert 0 in every MoE
    layer: coordinate ``j`` of the residual stream is a constant that no
    layer writes, and the router reads it into expert 0 alone."""
    params = tree_map(torch.clone, params)
    params["embed"]["table"][:, j] = 3.0
    for p in (params["prefix"][0], params["blocks"][0]):
        p["mix"]["o"]["w"][..., j] = 0.0
        p["norm2"]["w"][..., j] = 1.0
    params["prefix"][0]["ffn"]["wo"]["w"][:, j] = 0.0
    moe = params["blocks"][0]["ffn"]
    moe["wo"][..., j] = 0.0
    moe["shared"]["wo"]["w"][..., j] = 0.0
    moe["router"][:, j, 0] = big
    return params


def _expert_counters(fn):
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    session = telemetry.sessions()[0]
    counts = [r.attrs["value"] for r in session.named("moe.expert_tokens")]
    dropped = [int(r.attrs["value"]) for r in session.named("moe.dropped_tokens")]
    telemetry.clear()
    return out, counts, dropped


@pytest.mark.parametrize("n", LENGTHS)
def test_dropless_router_keeps_every_token_on_one_expert(params, n):
    forced = _forced_onto_expert_zero(params, CFG)
    seq = tokens(n, 7)
    fwd = lambda cfg: lm.forward(forced, torch.as_tensor(seq)[None], cfg, PAR)[0]  # noqa: E731
    logits, counts, dropped = _expert_counters(lambda: fwd(CFG))
    assert counts and all(int(c[0]) == n for c in counts)
    assert dropped == [0] * len(counts)
    want = reference_logits(forced, CFG, seq, torch.arange(n))
    assert rel(logits[0], want) < TOL
    # The reference package's router (renormalised gates, a capacity of
    # 1.25 x the mean load) drops tokens here, and the counter shows it.
    m = CFG.moe
    capacity = dataclasses.replace(CFG, moe=MoEConfig(n_experts=m.n_experts, top_k=m.top_k,
                                                      d_expert=m.d_expert, n_shared=m.n_shared))
    _, _, dropped = _expert_counters(lambda: fwd(capacity))
    assert dropped and min(dropped) > 0


def test_yarn_frequencies_and_scale_by_hand():
    cfg = registry.get("deepseek_v2_lite")
    # DeepSeek-V2-Lite: rope dim 64, theta 10000, factor 40 over 4096.
    corr = [64 * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(10000)) for r in (32, 1)]
    low, high = math.floor(corr[0]), math.ceil(corr[1])
    assert (low, high) == (10, 23)
    want = []
    for i in range(32):
        theta_i = 10000 ** (-2 * i / 64)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(theta_i / 40 * ramp + theta_i * (1 - ramp))
    want = torch.tensor(want, dtype=torch.float64)
    for got in (mla.yarn_inv_freq(cfg.mla, cfg.rope_theta), ref.yarn_inv_freq(hf_config(cfg))):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, rtol=1e-7, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    scale = 192 ** -0.5 * m * m
    assert mla.softmax_scale(cfg.mla) == pytest.approx(scale, rel=1e-12)
    assert ref.softmax_scale(hf_config(cfg)) == pytest.approx(scale, rel=1e-12)


@pytest.mark.parametrize("chunk", [None, 7])
def test_absorbed_and_expanded_agree_on_one_cache(params, chunk):
    """The same latent rows read both ways: the expanded path over the
    whole sequence, the absorbed path for its last tokens over a cache
    holding the earlier ones (``chunk`` keys at a time, or all)."""
    p = params["blocks"][0]["mix"]
    p = tree_map(lambda t: t[0], p)
    gen = torch.Generator().manual_seed(9)
    s, q = 24, 5
    x = torch.randn((2, s, CFG.d_model), generator=gen)
    positions = torch.arange(s)
    full, _ = mla.apply_mla(p, x, CFG, positions=positions)
    cache = mla.make_latent_cache(CFG, 2, s + 3, torch.float32, "cpu")
    cache["latent"][:, :s - q] = mla.latent_rows(p, x[:, :s - q], CFG, positions[:s - q])
    cache["len"].fill_(s - q)
    if chunk is None:
        got, cache = mla.apply_mla(p, x[:, s - q:], CFG, positions=positions[s - q:], cache=cache)
    else:
        q_nope, q_pe = mla._queries(p, x[:, s - q:], CFG, positions[s - q:])
        cache["latent"][:, s - q:s] = mla.latent_rows(p, x[:, s - q:], CFG, positions[s - q:])
        out = mla.absorbed_attention(q_nope, q_pe, cache["latent"], positions[s - q:],
                                     p["kv_b"]["w"], CFG.mla, chunk=chunk)
        got = linear(p["o"], out.reshape(2, q, -1))
    assert rel(got, full[:, s - q:]) < TOL


@pytest.mark.cuda
def test_recorded_decode_equals_the_eager_turn(params):
    """On a card the first turn decodes eagerly and records the decode step;
    a second turn on the same question replays the plain graph, a third,
    under a profiler, the instrumented one. Both give the eager turn's ids
    and logits (the same kernels on the same operands: 1e-6, not bit for
    bit, since a library may choose another algorithm inside a capture),
    and the instrumented replays add, under each decode step, one timed
    ``mla.attend`` per layer and one ``moe.expert_tokens`` per MoE layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    docs = np.stack([tokens(30, 3), tokens(30, 4)])
    q = tokens((2, 6), 5)
    eng = ServeEngine(CFG, PAR, tree_map(lambda t: t.to(dev), params), s_max=30 + 6 + 4,
                      device=dev)
    sess = eng.open_sessions(docs)
    ids1, logits1 = eng.turn(q, 4)
    assert sess.graphs is not None and int(sess.cache["pos"]) == 30
    ids2, logits2 = eng.turn(q, 4)
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ids3, logits3 = eng.turn(q, 4)
    session = telemetry.sessions()[0]
    telemetry.clear()
    for ids, logits in ((ids2, logits2), (ids3, logits3)):
        assert (ids == ids1).all()
        assert rel(logits, logits1) < 1e-6
    steps = session.named("lm.decode_step")
    assert len(steps) == 3
    n_moe = CFG.n_layers - len(CFG.prefix_layers)
    for step in steps:
        below = [r for r in session.records if r.parent is step]
        attend = [r for r in below if r.name == "mla.attend"]
        counts = [r for r in below if r.name == "moe.expert_tokens"]
        assert len(attend) == CFG.n_layers and all(r.device_ms() > 0 for r in attend)
        assert len(counts) == n_moe
        assert all(int(c.attrs["value"].sum()) == 2 * CFG.moe.top_k for c in counts)
