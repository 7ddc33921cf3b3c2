"""The LM sessions program: a DeepSeek-V2 model on ``repro_torch``'s LM
serving path, sessions that keep long documents resident in a latent cache.

A configuration that names ``"program": "lm_sessions"`` runs here. It holds
a Hugging Face ``config.json``'s numbers under their keys; ``model_config``
maps them onto the port's ``MLAModelConfig``. Set-up draws the weights from
the run's seed layer by layer with the reference's ``layer_weights`` and
``top_weights`` (bfloat16, as the checkpoint is stored) and loads them into
the port's parameter tree (``port_params``), builds a ``ServeEngine`` and
prefills one document per session into its latent cache
(``ServeEngine.open_sessions``); the warm-up (``TurnsClosedLoop.warm_up``)
runs one turn, which on the card also records the decode step as CUDA
graphs that the window's turns replay (``ServeEngine.turn``).

Traffic kind ``lm_turns``: a closed loop of turns (``ServeEngine.turn``).
Each turn gives every session a question from a seeded pool and decodes a
greedy answer; ``request_p99_ms`` is the 99th percentile, over the
window's requests (one per session and turn), of (answer ids on the host)
- (turn submitted). The judge draws the weights again after the program's
state is freed and runs the reference's full forward, layer by layer,
over document + question + the program's own answer (teacher-forced), and
compares the logits that chose each answer token over all of a sampled
session's answer positions, twice: ``turn_logit_rel_err`` is max |got -
want| / max |want| (one wrong logit), ``turn_logit_rms_err`` is ||got -
want|| / ||want|| (``rms_rel_err``). A routing choice that flips between
bfloat16 and float32 moves a few positions' logits, a token that loses its
routed experts moves every position's a little: the root mean square tells
them apart where the largest difference does not. The control is the
reference in ``fp8`` against the reference in float32.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models import lm, mla
from repro_torch.models.config import (DroplessMoEConfig, MLAConfig, MLAModelConfig,
                                       ParallelConfig, YarnRope)
from repro_torch.serve import ServeEngine
from repro_torch.tree import tree_map

from gspbench import drivers
from gspbench.reference import deepseek_v2 as ref

SAMPLE = "turn_logits"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_config(c: dict) -> MLAModelConfig:
    """The port's configuration of a DeepSeek-V2 ``config.json``. The
    port's router applies no ``routed_scaling_factor``: a configuration
    with another than 1 is refused."""
    if c["routed_scaling_factor"] != 1:
        raise ValueError(f"routed_scaling_factor {c['routed_scaling_factor']} is not implemented")
    y = c["rope_scaling"]
    dense = c["first_k_dense_replace"]
    return MLAModelConfig(
        name=c["name"].replace("_", "-"),
        family="moe",
        n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        d_ff=c["moe_intermediate_size"],
        vocab_size=c["vocab_size"],
        prefix_layers=(("mla", "dense_wide"),) * dense,
        pattern=("mla",),
        ffn_pattern=("moe",),
        dense_ff_override=c["intermediate_size"],
        act="swiglu",
        rope_theta=float(c["rope_theta"]),
        moe=DroplessMoEConfig(n_experts=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
                              d_expert=c["moe_intermediate_size"],
                              n_shared=c["n_shared_experts"], norm_topk=c["norm_topk_prob"]),
        mla=MLAConfig(kv_lora_rank=c["kv_lora_rank"], qk_nope_head_dim=c["qk_nope_head_dim"],
                      qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
                      rope_scaling=YarnRope(
                          factor=float(y["factor"]),
                          original_max_position=y["original_max_position_embeddings"],
                          beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
                          mscale=y["mscale"], mscale_all_dim=y["mscale_all_dim"])),
        tie_embeddings=c["tie_word_embeddings"],
        param_dtype=c["dtype"],
        activation_dtype=c["dtype"],
    )


def _port_layer(w: dict, dense: bool) -> dict:
    """One layer of the reference's weights in the port's block layout."""
    p = {"norm1": {"w": w["attn_norm"]}, "norm2": {"w": w["ffn_norm"]},
         "mix": {"q": {"w": w["wq"]}, "kv_a": {"w": w["wkv_a"]}, "kv_norm": {"w": w["kv_norm"]},
                 "kv_b": {"w": w["wkv_b"]}, "o": {"w": w["wo"]}}}
    if dense:
        p["ffn"] = {"wi_gate": {"w": w["w_gate"]}, "wi_up": {"w": w["w_up"]},
                    "wo": {"w": w["w_down"]}}
    else:
        p["ffn"] = {"router": w["router"], "wi_gate": w["experts_gate"],
                    "wi_up": w["experts_up"], "wo": w["experts_down"],
                    "shared": {"wi_gate": {"w": w["shared_gate"]}, "wi_up": {"w": w["shared_up"]},
                               "wo": {"w": w["shared_down"]}}}
    return p


def port_params(c: dict, cfg: MLAModelConfig, seed: int, device: torch.device) -> dict:
    """The run's weights (the reference's draw) in the port's parameter
    tree: each layer drawn, copied into place and dropped, so that set-up
    holds one layer beside the model."""
    shapes, _ = lm.abstract_init(cfg)
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), shapes)
    top = ref.top_weights(c, seed, device)
    params["embed"]["table"].copy_(top["embed"])
    params["embed"]["unembed"].copy_(top["head"])
    params["final_norm"]["w"].copy_(top["final_norm"])
    del top
    n_prefix = len(cfg.prefix_layers)
    for i in range(cfg.n_layers):
        layer = _port_layer(ref.layer_weights(c, seed, i, device), i < n_prefix)
        if i < n_prefix:
            dest = params["prefix"][i]
        else:
            dest = tree_map(lambda t, r=i - n_prefix: t[r], params["blocks"][0])
        tree_map(lambda d, s: d.copy_(s), dest, layer)
    return params


class Inputs:
    """The run's documents (sessions, doc_tokens) and question pool (pool,
    sessions, question_tokens) as int64 ids, the seed the weights come
    from, the reference's float32 logits once computed (the control is
    judged on the same samples), and the seconds the sessions' prefill
    took (``start``)."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        rng = np.random.default_rng([seed, 3])
        v, b = config["vocab_size"], traffic["sessions"]
        self.seed = seed
        self.documents = rng.integers(0, v, (b, traffic["doc_tokens"]), dtype=np.int64)
        self.questions = rng.integers(0, v, (traffic["question_pool"], b,
                                             traffic["question_tokens"]), dtype=np.int64)
        self.reference = {}
        self.session_prefill_s = None


class TurnsClosedLoop:
    """Turns back to back over resident sessions (``ServeEngine``)."""

    kind = "lm_turns"
    span_names = ("turn",)

    def __init__(self, engine: ServeEngine, traffic: dict, seed: int, inputs: Inputs):
        self.engine, self.traffic, self.inputs = engine, traffic, inputs
        self.device = engine.device
        rng = np.random.default_rng([seed, 1])
        self.sequence = rng.integers(0, traffic["question_pool"], 4096)
        self.kept = drivers.Reservoir(traffic["samples"], np.random.default_rng([seed, 2]))

    def open(self) -> None:
        self.engine.open_sessions(self.inputs.documents)
        _sync(self.device)

    def warm_up(self) -> None:
        self.engine.turn(self.inputs.questions[0], self.traffic["answer_tokens"])
        _sync(self.device)

    def window(self, seconds: float, tracer) -> dict:
        n, b = self.traffic["answer_tokens"], self.traffic["sessions"]
        latencies, count, t0 = [], 0, time.perf_counter()
        trace = drivers.TraceSlice(tracer, t0, seconds, self.traffic["trace_s"])
        while time.perf_counter() - t0 < seconds:
            trace.tick()
            qi = int(self.sequence[count % len(self.sequence)])
            t_submit = time.perf_counter()
            with tracer.span("turn"):
                ids, logits = self.engine.turn(self.inputs.questions[qi], n)
            latencies += [time.perf_counter() - t_submit] * b
            for s in range(b):
                self.kept.offer((qi, s, ids[s], logits[s]))
            count += 1
        trace.close()
        return {"metrics": {"request_p99_ms": 1e3 * float(np.percentile(latencies, 99))},
                "attempted": count * b, "failed": 0, "unanswered": 0,
                "counters": {"turns": count}}

    def operands(self) -> dict:
        """One absorbed-attention call at the cell's first decode step (the
        sessions' queries at row doc + question, layer 1's ``W_kv_b`` and
        latent cache), pure: it writes nothing."""
        sess, cfg = self.engine.sessions, self.engine.cfg
        if sess is None:
            return {}
        m, b, h = cfg.mla, self.traffic["sessions"], cfg.n_heads
        row = sess.length + self.traffic["question_tokens"]
        gen = torch.Generator(device=self.device).manual_seed(self.inputs.seed % 2**63)
        q_nope = torch.randn((b, 1, h, m.qk_nope_head_dim), generator=gen, device=self.device)
        q_pe = torch.randn((b, 1, h, m.qk_rope_head_dim), generator=gen, device=self.device)
        q_nope, q_pe = q_nope.to(cfg.dtype()), q_pe.to(cfg.dtype())
        layer = sess.cache["blocks"][0]["latent"][0]
        w_kv_b = self.engine.params["blocks"][0]["mix"]["kv_b"]["w"][0]
        q_rows = torch.tensor([row], device=self.device)
        return {"mla_call": lambda: mla.absorbed_attention(q_nope, q_pe, layer, q_rows, w_kv_b, m),
                "mla_shape": {"batch": b, "queries": 1, "keys": row + 1, "heads": h,
                              "rank": m.kv_lora_rank, "rope_dim": m.qk_rope_head_dim,
                              "nope_dim": m.qk_nope_head_dim, "v_dim": m.v_head_dim}}

    def samples(self):
        return [(SAMPLE, (qi, s, ids), logits.clone()) for qi, s, ids, logits in self.kept.items]

    def release(self) -> None:
        """Drop the model and the sessions (the samples stay)."""
        self.engine = None


KINDS = {TurnsClosedLoop.kind: TurnsClosedLoop}


def start(cell, seed: int, device: torch.device):
    """(inputs, engine, driver, seconds per stage: ``weights_s`` (the
    draw, with the device's first use), ``prep_s`` (the documents and
    questions drawn, the engine built), ``session_prefill_s`` (the
    sessions' prefill, also kept on ``inputs`` for ``context``),
    ``warm_up_s`` (one turn))."""
    t0 = time.perf_counter()
    c, t = cell.config, cell.traffic
    cfg = model_config(c)
    params = port_params(c, cfg, seed, device)
    _sync(device)
    t_prep = time.perf_counter()
    inputs = Inputs(c, t, seed)
    engine = ServeEngine(cfg, ParallelConfig(), params, device=device,
                         s_max=t["doc_tokens"] + t["question_tokens"] + t["answer_tokens"])
    driver = KINDS[t["kind"]](engine, t, seed, inputs)
    t_open = time.perf_counter()
    driver.open()
    t_warm = time.perf_counter()
    driver.warm_up()
    inputs.session_prefill_s = t_warm - t_open
    stages = {"weights_s": t_prep - t0, "prep_s": t_open - t_prep,
              "session_prefill_s": inputs.session_prefill_s,
              "warm_up_s": time.perf_counter() - t_warm}
    return inputs, engine, driver, stages


def context(cell, inputs: Inputs) -> dict:
    return {"session_prefill_s": inputs.session_prefill_s}


def _reference_logits(cell, inputs: Inputs, keys, device, precision: str) -> dict:
    """The reference's logits at each sampled answer's positions, the
    weights drawn again one layer at a time."""
    c, t = cell.config, cell.traffic
    d, q, n = t["doc_tokens"], t["question_tokens"], t["answer_tokens"]
    top = ref.top_weights(c, inputs.seed, device)
    xs, seqs = [], []
    for qi, s, ids in keys:
        seq = np.concatenate([inputs.documents[s], inputs.questions[qi][s], ids[:n - 1]])
        seqs.append(torch.as_tensor(seq, device=device))
        xs.append(ref.embed(top, seqs[-1]))
    positions = torch.arange(d + q + n - 1, device=device)
    for i in range(c["num_hidden_layers"]):
        w = ref.layer_weights(c, inputs.seed, i, device)
        xs = [ref.block(w, x, positions, c, i, precision) for x in xs]
        del w
    at = torch.arange(d + q - 1, d + q + n - 1, device=device)
    return {_key(k): ref.logits_at(top, x, at, c, precision) for k, x in zip(keys, xs)}


def rms_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over every element, in float64."""
    want = want.to(torch.float64)
    diff = got.to(device=want.device, dtype=torch.float64) - want
    return float(diff.norm() / want.norm().clamp_min(1e-300))


def _key(key) -> tuple:
    qi, s, ids = key
    return qi, s, tuple(int(i) for i in ids)


def judge(cell, inputs: Inputs, driver, samples, precision: str) -> dict:
    """The checks' worst readings over the sampled answers against the
    float32 reference; ``precision="tf32"`` judges the control (the
    reference in ``fp8``) in the answers' place."""
    if not samples:
        return {}
    device = driver.device
    keys = [key for _, key, _ in samples]
    missing = [k for k in keys if _key(k) not in inputs.reference]
    if missing:
        inputs.reference.update(_reference_logits(cell, inputs, missing, device, "float32"))
    got = {_key(k): answer for _, k, answer in samples}
    if precision == "tf32":
        got = _reference_logits(cell, inputs, keys, device, "fp8")
    pairs = [(got[_key(k)], inputs.reference[_key(k)]) for k in keys]
    return {"turn_logit_rel_err": max(drivers.rel_err(g, w) for g, w in pairs),
            "turn_logit_rms_err": max(rms_rel_err(g, w) for g, w in pairs)}


def tiny(cell) -> None:
    """The cell shrunk in place for the CPU tests: d 64, 4 heads, latent 32,
    rope 16, nope and v 32, 10 layers (the first dense), and the full
    model's routing grain (64 experts, top-6, 2 shared) at expert width
    16, over a 512-id vocabulary; 2 sessions of 48 tokens, 8-token
    questions and 4-token answers. (With 8 experts top-3 a routing flip
    between bfloat16 and float32 moves a tenth of a token's FFN and the
    readings' tail crosses the control's.)"""
    c = cell.config
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, moe_intermediate_size=16,
             intermediate_size=128, num_hidden_layers=10, vocab_size=512)
    c["rope_scaling"] = dict(c["rope_scaling"], original_max_position_embeddings=64)
    cell.traffic.update(sessions=2, doc_tokens=48, question_tokens=8, answer_tokens=4,
                        question_pool=2, trace_s=0.2)
