"""Unified decoder LM covering all assigned architecture families.

Mirrors ``repro/models/lm.py``. A model is: embedding -> [prefix layers]
-> repeated block patterns -> final norm -> (tied) unembedding. Each
pattern entry is a (mixing layer kind, ffn kind) pair; kinds cover
full/local attention, latent attention (``mla``, in an ``MLAModelConfig``:
no counterpart in the reference), Mamba, mLSTM and sLSTM; ffns cover dense
(swiglu/geglu/relu2) and MoE.

The functions work on a tree of tensors with the reference's structure:
``embed``, a ``prefix`` list, a ``blocks`` tuple (one dict per pattern
entry, every leaf stacked over ``repeats`` on a leading axis) and
``final_norm``; ``repro_torch.tree`` flattens it in jax's leaf order. The
reference's ``lax.scan`` over groups is a Python loop over the repeats:
each stacked param leaf is unbound once per call (``torch.unbind``, whose
backward stacks the groups' gradients into one tensor; a per-group
``t[r]`` would make every group's backward write a zero tensor the size
of the whole stack). Cache leaves stay per-group ``t[r]`` views, so a
decode step's writes land in the stacked cache.

``loss_fn`` is differentiable with respect to the param leaves (torch
autograd; ``repro_torch.train`` takes gradients with
``torch.autograd.grad``). ``par.remat == "block"`` checkpoints each
repeat group while autograd records
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``), as
the reference's ``jax.checkpoint(group)`` does: a group's activations are
recomputed in its backward instead of being kept.

Entry points:
  init(gen, cfg, device)          -> (params, logical specs)
  abstract_init(cfg)              -> (meta-device params, specs)  [shapes only]
  forward(params, tokens, ...)    -> (logits, aux)               [train/prefill]
  loss_fn(params, batch, ...)     -> (loss, metrics)              [differentiable]
  init_cache / prefill / decode_step                              [serving]
  extend / rewind                     [sessions over attention and latent caches]

``decode_step`` updates the cache IN PLACE and returns it: the token's
k/v go into the attention buffers at ``len``, recurrent states are
overwritten, and ``len`` / ``pos`` (0-d int32 device tensors) advance on
the device, so a step copies no cache and makes no host sync. A caller
gives its cache up to the step, as jit donation does in the reference.
``extend`` does the same for several tokens at once and ``rewind`` sets
the lengths back, so that a session's later tokens are overwritten; both
take only attention and latent caches, whose rows past the length are
masked.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.sharding import ShardingRules, constrain, stack_specs
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["init", "abstract_init", "forward", "loss_fn", "init_cache",
           "decode_step", "prefill", "extend", "rewind", "cache_logical_specs"]


# ------------------------------------------------------------- blocks ---


def _init_block(rng: L.Init, cfg: ModelConfig, kind: str, ffn_kind: str, dtype):
    p, s = {}, {}
    p["norm1"], s["norm1"] = L.init_norm(rng, cfg, dtype)
    if kind in ("attn", "local_attn"):
        p["mix"], s["mix"] = L.init_attention(rng, cfg, dtype)
    elif kind == "mla":
        p["mix"], s["mix"] = MLA.init_mla(rng, cfg, dtype)
    elif kind == "mamba":
        p["mix"], s["mix"] = M.init_mamba(rng, cfg, dtype)
    elif kind == "mlstm":
        p["mix"], s["mix"] = X.init_mlstm(rng, cfg, dtype)
    elif kind == "slstm":
        p["mix"], s["mix"] = X.init_slstm(rng, cfg, dtype)
    else:
        raise ValueError(kind)
    if cfg.post_block_norm:
        p["postnorm1"], s["postnorm1"] = L.init_norm(rng, cfg, dtype)
    if ffn_kind != "none":
        p["norm2"], s["norm2"] = L.init_norm(rng, cfg, dtype)
        if ffn_kind == "dense":
            p["ffn"], s["ffn"] = L.init_dense_ffn(rng, cfg, dtype)
        elif ffn_kind == "dense_wide":  # prefix dense layer of MoE models
            p["ffn"], s["ffn"] = L.init_dense_ffn(
                rng, cfg, dtype, d_ff=cfg.dense_ff_override or cfg.d_ff)
        elif ffn_kind == "moe":
            p["ffn"], s["ffn"] = MOE.init_moe(rng, cfg, dtype)
        else:
            raise ValueError(ffn_kind)
        if cfg.post_block_norm:
            p["postnorm2"], s["postnorm2"] = L.init_norm(rng, cfg, dtype)
    return p, s


def _apply_block(
    p, x, cfg: ModelConfig, par: ParallelConfig,
    rules: ShardingRules | None, kind: str, ffn_kind: str,
    positions, cache=None,
):
    """Returns (x, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    new_cache = None
    if kind in ("attn", "local_attn"):
        window = cfg.window_size if kind == "local_attn" else None
        h, new_cache = L.apply_attention(
            p["mix"], h, cfg, rules=rules, positions=positions,
            window=window, impl=par.attn_impl, chunk=par.attn_chunk,
            cache=cache)
    elif kind == "mla":
        h, new_cache = MLA.apply_mla(p["mix"], h, cfg, positions=positions, cache=cache)
    elif kind == "mamba":
        h, new_cache = M.apply_mamba(
            p["mix"], h, cfg, rules=rules, chunk=par.mamba_chunk, state=cache)
    elif kind == "mlstm":
        h, new_cache = X.apply_mlstm(
            p["mix"], h, cfg, rules=rules, chunk=par.mamba_chunk, state=cache)
    elif kind == "slstm":
        h, new_cache = X.apply_slstm(p["mix"], h, cfg, rules=rules, state=cache)
    if cfg.post_block_norm:
        h = L.apply_norm(p["postnorm1"], h, cfg.norm)
    x = x + h
    x = constrain(x, rules, "act_batch", "act_seq", None)

    if ffn_kind != "none":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        if ffn_kind == "moe":
            h, aux = MOE.apply_moe(p["ffn"], h, cfg, rules=rules,
                                   n_groups=par.moe_groups,
                                   capacity_factor=par.moe_capacity)
        else:
            h = L.apply_dense_ffn(p["ffn"], h, cfg.act)
        if cfg.post_block_norm:
            h = L.apply_norm(p["postnorm2"], h, cfg.norm)
        x = x + h
        x = constrain(x, rules, "act_batch", "act_seq", None)
    return x, new_cache, aux


def _make_block_cache(cfg, kind: str, batch: int, s_max: int, dtype, device, lead=()):
    if kind in ("attn", "local_attn"):
        return L.make_cache(cfg, batch, s_max, dtype, device, lead)
    if kind == "mla":
        return MLA.make_latent_cache(cfg, batch, s_max, dtype, device, lead)
    if kind == "mamba":
        return M.make_mamba_state(cfg, batch, dtype, device, lead)
    if kind == "mlstm":
        return X.make_mlstm_state(cfg, batch, device, lead)
    if kind == "slstm":
        return X.make_slstm_state(cfg, batch, device, lead)
    raise ValueError(kind)


def _groups(cfg: ModelConfig, params, cache=None):
    """Per repeat: (params group, cache group or None). Param leaves are
    unbound once (one stacked gradient per leaf); cache groups are ``t[r]``
    views (writes into them land in the stacked cache)."""
    leaves, treedef = tree_flatten(params["blocks"])
    per_leaf = [torch.unbind(t, 0) for t in leaves]
    for r in range(cfg.repeats):
        p_group = treedef.unflatten([u[r] for u in per_leaf])
        c_group = None if cache is None else tree_map(lambda t: t[r], cache["blocks"])
        yield p_group, c_group


# ---------------------------------------------------------------- init --


def init(gen: torch.Generator, cfg: ModelConfig, device: str | torch.device | None = None):
    """Materialize parameters on ``device`` (default ``cuda``), drawn from
    ``gen``, a ``torch.Generator`` on that device. Returns (params,
    logical_spec_tree)."""
    return _init(L.Init(gen, resolve_device(device)), cfg)


def _init(rng: L.Init, cfg: ModelConfig):
    dtype = cfg.pdtype()
    p: dict[str, Any] = {}
    s: dict[str, Any] = {}
    p["embed"], s["embed"] = L.init_embedding(rng, cfg, dtype)

    prefix_p, prefix_s = [], []
    for kind, ffn_kind in cfg.prefix_layers:
        bp, bs = _init_block(rng, cfg, kind, ffn_kind, dtype)
        prefix_p.append(bp)
        prefix_s.append(bs)
    if prefix_p:
        p["prefix"], s["prefix"] = prefix_p, prefix_s

    # Stacked pattern groups: each leaf drawn at once over the repeats.
    stacked = rng.stacked(cfg.repeats)
    group = [_init_block(stacked, cfg, kind, ffn_kind, dtype)
             for kind, ffn_kind in zip(cfg.pattern, cfg.ffn_pattern)]
    p["blocks"] = tuple(bp for bp, _ in group)
    s["blocks"] = stack_specs(tuple(bs for _, bs in group))

    p["final_norm"], s["final_norm"] = L.init_norm(rng, cfg, dtype)
    return p, s


def abstract_init(cfg: ModelConfig):
    """Shape-only init on the ``meta`` device (no memory): (params, specs).
    Every leaf has the shape and dtype ``init`` gives it."""
    return _init(L.Init(None, torch.device("meta")), cfg)


# -------------------------------------------------------------- forward --


def _embed_tokens(p, cfg, tokens, extra_embeds, rules):
    x = p["embed"]["table"][tokens]
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if extra_embeds is not None:
        # [vlm]/[audio] stub: frontend supplies embeddings for the first
        # ``P`` positions; token embeddings fill the rest.
        pfx = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(x.dtype), x[:, pfx:]], dim=1)
    return constrain(x, rules, "act_batch", "act_seq", None)


def _unembed(p, cfg, x, rules):
    table = p["embed"].get("unembed")
    if table is None:
        table = p["embed"]["table"].T
    logits = L.softcap(x @ table, cfg.logit_softcap)
    return constrain(logits, rules, "act_batch", "act_seq", "act_vocab")


def forward(
    params,
    tokens,
    cfg: ModelConfig,
    par: ParallelConfig,
    rules: ShardingRules | None = None,
    extra_embeds=None,
    last_only: bool = False,
):
    """Full-sequence forward (train / prefill): tokens (B, S) -> logits.

    ``last_only=True`` unembeds only the final position (serving prefill:
    the next-token logits are all the scheduler needs)."""
    x = _embed_tokens(params, cfg, tokens, extra_embeds, rules)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    for i, (kind, ffn_kind) in enumerate(cfg.prefix_layers):
        x, _, aux = _apply_block(params["prefix"][i], x, cfg, par, rules, kind, ffn_kind,
                                 positions)
        aux_total = aux_total + aux

    def group(x, p_group):
        aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (kind, ffn_kind) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            x, _, aux = _apply_block(p_group[i], x, cfg, par, rules, kind, ffn_kind, positions)
            aux_g = aux_g + aux
        return x, aux_g

    remat = par.remat == "block" and torch.is_grad_enabled()
    for p_group, _ in _groups(cfg, params):
        if remat:
            x, aux_g = checkpoint(group, x, p_group, use_reentrant=False)
        else:
            x, aux_g = group(x, p_group)
        aux_total = aux_total + aux_g

    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if last_only:
        x = x[:, -1:]
    return _unembed(params, cfg, x, rules), aux_total


def loss_fn(
    params,
    batch: dict,
    cfg: ModelConfig,
    par: ParallelConfig,
    rules: ShardingRules | None = None,
    aux_weight: float = 0.01,
):
    """Next-token CE (labels = -1 masked) + MoE load-balance aux."""
    logits, aux = forward(params, batch["tokens"], cfg, par, rules,
                          extra_embeds=batch.get("extra_embeds"))
    labels = batch["labels"]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = torch.sum((lse - ll) * mask) / torch.clamp_min(mask.sum(), 1.0)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": mask.sum()}


# ------------------------------------------------------------- serving --


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype,
               device: str | torch.device | None = None):
    """Cache tree: prefix list + per-pattern-entry stacked over repeats,
    on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    cache = {}
    if cfg.prefix_layers:
        cache["prefix"] = [_make_block_cache(cfg, kind, batch, s_max, dtype, dev)
                           for kind, _ in cfg.prefix_layers]
    cache["blocks"] = tuple(
        _make_block_cache(cfg, kind, batch, s_max, dtype, dev, (cfg.repeats,))
        for kind in cfg.pattern)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)  # next-token position
    return cache


def _block_cache_specs(cfg: ModelConfig, kind: str):
    """Logical sharding specs mirroring _make_block_cache."""
    if kind in ("attn", "local_attn"):
        return {
            "k": ("act_kv_batch", "act_kv_seq", "act_kv_heads", None),
            "v": ("act_kv_batch", "act_kv_seq", "act_kv_heads", None),
            "len": (),
        }
    if kind == "mla":
        return {"latent": ("act_kv_batch", "act_kv_seq", None), "len": ()}
    if kind == "mamba":
        return {"conv": ("act_batch", None, "act_ffn"),
                "ssm": ("act_batch", "act_ffn", None)}
    if kind == "mlstm":
        return {"C": ("act_batch", "act_heads", None, None),
                "n": ("act_batch", "act_heads", None),
                "m": ("act_batch", "act_heads")}
    if kind == "slstm":
        return {k: ("act_batch", None) for k in ("c", "n", "m", "h")}
    raise ValueError(kind)


def cache_logical_specs(cfg: ModelConfig):
    """Spec tree matching init_cache's structure (stacked groups get the
    leading p_layers axis)."""
    specs = {}
    if cfg.prefix_layers:
        specs["prefix"] = [_block_cache_specs(cfg, kind) for kind, _ in cfg.prefix_layers]
    specs["blocks"] = stack_specs(tuple(_block_cache_specs(cfg, kind) for kind in cfg.pattern))
    specs["pos"] = ()
    return specs


def decode_step(
    params,
    token,
    cache,
    cfg: ModelConfig,
    par: ParallelConfig,
    rules: ShardingRules | None = None,
):
    """One decode step: token (B, 1) int -> (logits (B, 1, V), cache).

    The cache is updated in place and returned (module docstring)."""
    return _through_cache(params, token, cache, cache["pos"][None], cfg, par, rules)


def extend(
    params,
    tokens,
    cache,
    cfg: ModelConfig,
    par: ParallelConfig,
    rules: ShardingRules | None = None,
    last_only: bool = False,
):
    """Run tokens (B, q) on from the cache's position through the cache:
    each token attends over the cache and the tokens before it. Returns
    (logits (B, q, V), or (B, 1, V) with ``last_only``, cache); the cache
    is updated in place. Latent-attention caches only (a per-head
    attention cache masks one new token at a time)."""
    kinds = {k for k, _ in cfg.prefix_layers} | set(cfg.pattern)
    if kinds != {"mla"}:
        raise ValueError(f"{cfg.name}: extend runs latent-attention layers only, not {kinds}")
    positions = cache["pos"] + torch.arange(tokens.shape[1], device=cache["pos"].device)
    return _through_cache(params, tokens, cache, positions, cfg, par, rules, last_only)


def _through_cache(params, tokens, cache, positions, cfg, par, rules, last_only=False):
    x = _embed_tokens(params, cfg, tokens, None, rules)

    for i, (kind, ffn_kind) in enumerate(cfg.prefix_layers):
        x, _, _ = _apply_block(params["prefix"][i], x, cfg, par, rules, kind, ffn_kind,
                               positions, cache=cache["prefix"][i])

    for p_group, c_group in _groups(cfg, params, cache):
        for i, (kind, ffn_kind) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            x, _, _ = _apply_block(p_group[i], x, cfg, par, rules, kind, ffn_kind,
                                   positions, cache=c_group[i])
    cache["pos"].add_(tokens.shape[1])

    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if last_only:
        x = x[:, -1:]
    return _unembed(params, cfg, x, rules), cache


def rewind(cache, length: int, cfg: ModelConfig):
    """Set the cache back to its first ``length`` tokens, in place: the
    rows after them are masked until later tokens overwrite them.
    Attention and latent caches only (recurrent state has no rows)."""
    kinds = {k for k, _ in cfg.prefix_layers} | set(cfg.pattern)
    if not kinds <= {"attn", "local_attn", "mla"}:
        raise ValueError(f"{cfg.name}: recurrent state cannot rewind ({sorted(kinds)})")
    for layer in [*cache.get("prefix", []), *cache["blocks"]]:
        layer["len"].fill_(length)
    cache["pos"].fill_(length)
    return cache


def prefill(
    params,
    tokens,
    cfg: ModelConfig,
    par: ParallelConfig,
    rules: ShardingRules | None = None,
    s_max: int | None = None,
    extra_embeds=None,
):
    """Run the full prompt, building a decode cache on the tokens' device.

    As in the reference: the train path for the logits, plus a second
    k/v projection per attention block to fill the cache, and for
    recurrent blocks a token-sequential pass that builds the state. A
    latent-attention block writes its latent rows (``mla.latent_rows``).
    """
    b, s = tokens.shape
    s_max = s_max or s
    if s > s_max:
        raise ValueError(f"prompt of {s} tokens does not fit s_max={s_max}")
    x = _embed_tokens(params, cfg, tokens, extra_embeds, rules)
    positions = torch.arange(s, device=x.device)

    def run_block(p_block, x, kind, ffn_kind, cache):
        # prefill uses the train path for mixing, then writes the cache.
        x_out, _, _ = _apply_block(p_block, x, cfg, par, rules, kind, ffn_kind, positions)
        if kind in ("attn", "local_attn"):
            h = L.apply_norm(p_block["norm1"], x, cfg.norm)
            k = L.linear(p_block["mix"]["k"], h).reshape(b, s, cfg.n_kv_heads, cfg.head_dim_)
            v = L.linear(p_block["mix"]["v"], h).reshape(b, s, cfg.n_kv_heads, cfg.head_dim_)
            k = L.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
            cache["k"][:, :s].copy_(k)
            cache["v"][:, :s].copy_(v)
            cache["len"].fill_(s)
        elif kind == "mla":
            h = L.apply_norm(p_block["norm1"], x, cfg.norm)
            cache["latent"][:, :s].copy_(MLA.latent_rows(p_block["mix"], h, cfg, positions))
            cache["len"].fill_(s)
        else:
            _prefill_state(p_block, x, cfg, par, rules, kind, cache)
        return x_out

    cache = init_cache(cfg, b, s_max, cfg.dtype(), x.device)
    for i, (kind, ffn_kind) in enumerate(cfg.prefix_layers):
        x = run_block(params["prefix"][i], x, kind, ffn_kind, cache["prefix"][i])

    for p_group, c_group in _groups(cfg, params, cache):
        for i, (kind, ffn_kind) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            x = run_block(p_group[i], x, kind, ffn_kind, c_group[i])
    cache["pos"].fill_(s)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = _unembed(params, cfg, x[:, -1:, :], rules)
    return logits, cache


def _prefill_state(p_block, x, cfg, par, rules, kind, cache):
    """Build recurrent state in ``cache`` by stepping the mixing layer over
    the prompt (token-sequential, as the reference does)."""
    h = L.apply_norm(p_block["norm1"], x, cfg.norm)
    for t in range(h.shape[1]):
        h_t = h[:, t:t + 1]
        if kind == "mamba":
            M.apply_mamba(p_block["mix"], h_t, cfg, rules=rules, state=cache)
        elif kind == "mlstm":
            X.apply_mlstm(p_block["mix"], h_t, cfg, rules=rules, state=cache)
        else:
            X.apply_slstm(p_block["mix"], h_t, cfg, rules=rules, state=cache)
