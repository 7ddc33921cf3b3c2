"""xLSTM blocks (Beck et al. 2024): mLSTM (matrix memory, chunkwise-
parallel) and sLSTM (scalar memory, exponential gating, sequential scan).

Mirrors ``repro/models/xlstm.py``. mLSTM uses the chunkwise-recurrent
form: per chunk a quadratic intra-chunk attention-like term plus an
inter-chunk contribution from the carried (C, n, m) state, with the
paper's max-state stabiliser. sLSTM is a per-head recurrent cell stepped
over the sequence. The reference's scans over chunks and tokens are
Python loops here; decode writes the new state into the state tensors in
place.

Both blocks embed their own channel mixing (the configs set d_ff = 0).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, apply_norm
from repro_torch.models.sharding import ShardingRules, constrain

__all__ = [
    "init_mlstm", "apply_mlstm", "make_mlstm_state",
    "init_slstm", "apply_slstm", "make_slstm_state",
]


# ------------------------------------------------------------- mLSTM ----


def init_mlstm(rng: Init, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    nh = cfg.n_heads
    hd = di // nh
    if nh * hd != di:
        raise ValueError(f"mLSTM width {di} is not a multiple of {nh} heads")
    p = {
        "up": rng.normal((d, 2 * di), d, dtype),
        "q": rng.normal((di, di), di, dtype),
        "k": rng.normal((di, di), di, dtype),
        "v": rng.normal((di, di), di, dtype),
        "wi": rng.normal((di, nh), di, torch.float32),  # input gate
        "wf": rng.normal((di, nh), di, torch.float32),  # forget gate
        "bi": rng.full((nh,), 0.0, torch.float32),
        "bf": rng.full((nh,), 3.0, torch.float32),  # forget-open init
        "gn": rng.full((di,), 1.0, dtype),           # multi-head norm
        "down": rng.normal((di, d), di, dtype),
    }
    s = {
        "up": ("d_model", "ffn"), "q": ("ffn", "ffn"), "k": ("ffn", "ffn"),
        "v": ("ffn", "ffn"), "wi": ("ffn", "heads"), "wf": ("ffn", "heads"),
        "bi": ("heads",), "bf": ("heads",), "gn": ("ffn",),
        "down": ("ffn", "d_model"),
    }
    return p, s


def _mh_norm(x, w, nh):
    """Head-wise RMS norm of (B, S, di) viewed as (B, S, nh, hd)."""
    b, s_len, di = x.shape
    xh = x.reshape(b, s_len, nh, di // nh).float()
    xh = xh * torch.rsqrt((xh * xh).mean(-1, keepdim=True) + 1e-6)
    return (xh.reshape(b, s_len, di) * w).to(x.dtype)


def _mlstm_chunk(carry, q_i, k_i, v_i, ii, ff, out_dtype):
    """One chunk of the chunkwise-recurrent mLSTM: (new carry, h)."""
    c_st, n_st, m_st = carry  # (B,nh,hd,hd), (B,nh,hd), (B,nh)
    # cumulative log-forget within the chunk (inclusive)
    fcum = torch.cumsum(ff, dim=1)  # (B,c,nh)
    # intra-chunk decay: D[t,s] = fcum_t - fcum_s + i_s  (s <= t)
    dmat = fcum[:, :, None] - fcum[:, None, :] + ii[:, None, :, :]  # (B,t,s,nh)
    c = dmat.shape[1]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dmat.device))
    dmat = torch.where(tri[None, :, :, None], dmat, -math.inf)
    # inter-chunk: state contribution decayed by fcum_t, with m_st
    m_intra = dmat.amax(2)  # (B,t,nh)
    m_inter = fcum + m_st[:, None]
    m_new = torch.maximum(m_intra, m_inter)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)

    w_intra = torch.exp(dmat - m_safe[:, :, None])  # (B,t,s,nh)
    scores = torch.einsum("bthd,bshd->btsh", q_i.float(), k_i.float())
    num_intra = torch.einsum("btsh,bshd->bthd", scores * w_intra, v_i.float())
    # denominator per the paper: (sum_s weights * q.k) per head
    den_intra = (scores * w_intra).sum(2)

    w_inter = torch.exp(m_inter - m_safe)  # (B,t,nh)
    qf = q_i.float()
    num_inter = torch.einsum("bthd,bhde->bthe", qf, c_st) * w_inter[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", qf, n_st) * w_inter

    denom = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_safe)) + 1e-6
    h = (num_intra + num_inter) / denom[..., None]

    # ---- state update to end of chunk ----
    f_tot = fcum[:, -1]  # (B,nh)
    # per-position decay to chunk end: fcum_end - fcum_s + i_s
    dend = f_tot[:, None] - fcum + ii  # (B,c,nh)
    m_next = torch.maximum(f_tot + m_st, dend.amax(1))
    w_upd = torch.exp(dend - m_next[:, None])  # (B,c,nh)
    kf, vf = k_i.float(), v_i.float()
    decay = torch.exp(f_tot + m_st - m_next)
    c_new = c_st * decay[..., None, None] + torch.einsum("bshd,bshe,bsh->bhde", kf, vf, w_upd)
    n_new = n_st * decay[..., None] + torch.einsum("bshd,bsh->bhd", kf, w_upd)
    return (c_new, n_new, m_next), h.to(out_dtype)


def apply_mlstm(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    rules: ShardingRules | None,
    chunk: int = 256,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, d). Decode (S == 1): carried {C, n, m} per head, updated
    in place."""
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    nh = cfg.n_heads
    hd = di // nh
    b, s_len, _ = x.shape

    a, z = torch.chunk(x @ p["up"], 2, dim=-1)  # (B,S,di) x2
    a = constrain(a, rules, "act_batch", None, "act_ffn")
    q = (a @ p["q"]).reshape(b, s_len, nh, hd) / math.sqrt(hd)
    k = (a @ p["k"]).reshape(b, s_len, nh, hd)
    v = (a @ p["v"]).reshape(b, s_len, nh, hd)
    af = a.float()
    i_pre = af @ p["wi"] + p["bi"]  # (B,S,nh)
    f_pre = af @ p["wf"] + p["bf"]
    logf = F.logsigmoid(f_pre)

    if state is None:
        n_chunks = -(-s_len // chunk)
        pad = n_chunks * chunk - s_len
        if pad:
            q = F.pad(q, (0, 0, 0, 0, 0, pad))
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            i_pre = F.pad(i_pre, (0, 0, 0, pad), value=-1e9)
            logf = F.pad(logf, (0, 0, 0, pad))

        carry = (torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device),
                 torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device),
                 torch.full((b, nh), -1e30, dtype=torch.float32, device=x.device))
        hs = []
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            carry, h = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl],
                                    logf[:, sl], x.dtype)
            hs.append(h)
        h = torch.cat(hs, dim=1)[:, :s_len]
        new_state = None
    else:
        # ---- O(1) decode ----
        c_st, n_st, m_st = state["C"], state["n"], state["m"]
        ii, ff = i_pre[:, 0], logf[:, 0]  # (B,nh)
        m_new = torch.maximum(ff + m_st, ii)
        kf, vf = k[:, 0].float(), v[:, 0].float()
        c_new = (c_st * torch.exp(ff + m_st - m_new)[..., None, None]
                 + torch.exp(ii - m_new)[..., None, None] * torch.einsum("bhd,bhe->bhde", kf, vf))
        n_new = (n_st * torch.exp(ff + m_st - m_new)[..., None]
                 + torch.exp(ii - m_new)[..., None] * kf)
        qf = q[:, 0].float()
        num = torch.einsum("bhd,bhde->bhe", qf, c_new)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n_new)),
                            torch.exp(-torch.where(torch.isfinite(m_new), m_new, 0.0)))
        h = (num / (den[..., None] + 1e-6))[:, None].reshape(b, 1, nh, hd).to(x.dtype)
        c_st.copy_(c_new)
        n_st.copy_(n_new)
        m_st.copy_(m_new)
        new_state = state

    h = _mh_norm(h.reshape(b, -1, di), p["gn"], nh)
    out = (h * F.silu(z)) @ p["down"]
    return out, new_state


def make_mlstm_state(cfg: ModelConfig, batch: int, device,
                     lead: tuple[int, ...] = ()) -> dict:
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    nh = cfg.n_heads
    hd = di // nh
    lead = tuple(lead)
    return {
        "C": torch.zeros(lead + (batch, nh, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros(lead + (batch, nh, hd), dtype=torch.float32, device=device),
        "m": torch.full(lead + (batch, nh), -1e30, dtype=torch.float32, device=device),
    }


# ------------------------------------------------------------- sLSTM ----


def init_slstm(rng: Init, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dp = int(cfg.slstm_proj_factor * d)

    def gatep(bias: float):
        return {
            "w": rng.normal((d, d), d, torch.float32),
            "r": rng.normal((nh, hd, hd), hd, torch.float32),
            "b": rng.full((d,), bias, torch.float32),
        }

    p = {
        "z": gatep(0.0), "i": gatep(0.0),
        "f": gatep(3.0), "o": gatep(0.0),
        "gn": rng.full((d,), 1.0, dtype),
        "up_gate": rng.normal((d, dp), d, dtype),
        "up": rng.normal((d, dp), d, dtype),
        "down": rng.normal((dp, d), dp, dtype),
    }
    gs = {"w": ("d_model", "d_model"), "r": ("heads", None, None),
          "b": ("d_model",)}
    s = {
        "z": gs, "i": gs, "f": gs, "o": gs, "gn": ("d_model",),
        "up_gate": ("d_model", "ffn"), "up": ("d_model", "ffn"),
        "down": ("ffn", "d_model"),
    }
    return p, s


def apply_slstm(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    rules: ShardingRules | None,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Sequential sLSTM with exponential gating + stabilizer state.

    States per head-dim: c (cell), n (normalizer), m (stabilizer), h;
    with ``state`` given they are updated in place.
    """
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    b, s_len, _ = x.shape
    xf = x.float()

    pre = {g: xf @ p[g]["w"] + p[g]["b"] for g in ("z", "i", "f", "o")}

    def rec(g, hh):
        return torch.einsum("bhd,hde->bhe", hh, p[g]["r"]).reshape(b, d)

    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        c, n, m, h = zeros, zeros, torch.full((b, d), -1e30, device=x.device), zeros
    else:
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for t in range(s_len):
        hh = h.reshape(b, nh, hd)
        z = torch.tanh(pre["z"][:, t] + rec("z", hh))
        o = torch.sigmoid(pre["o"][:, t] + rec("o", hh))
        i_t = pre["i"][:, t] + rec("i", hh)
        f_t = F.logsigmoid(pre["f"][:, t] + rec("f", hh))
        m_new = torch.maximum(f_t + m, i_t)
        ig = torch.exp(i_t - m_new)
        fg = torch.exp(f_t + m - m_new)
        c = fg * c + ig * z
        n = fg * n + ig
        m = m_new
        h = o * c / (n + 1e-6)
        hs.append(h)
    hseq = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,d)

    hseq = apply_norm({"w": p["gn"]}, hseq, "rmsnorm")
    up = hseq @ p["up"]
    out = (F.gelu(hseq @ p["up_gate"], approximate="tanh") * up) @ p["down"]  # jax's gelu
    new_state = None
    if state is not None:
        for key, val in (("c", c), ("n", n), ("m", m), ("h", h)):
            state[key].copy_(val)
        new_state = state
    return out, new_state


def make_slstm_state(cfg: ModelConfig, batch: int, device,
                     lead: tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    shape = tuple(lead) + (batch, d)

    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"c": z(), "n": z(), "m": torch.full(shape, -1e30, dtype=torch.float32,
                                                device=device), "h": z()}
