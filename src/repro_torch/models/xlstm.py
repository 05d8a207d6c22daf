"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent gate connections), with exponential gating and a stabiliser
state, following arXiv:2405.04517.

The port of `repro/models/xlstm.py` (plain JAX there, no Pallas
kernel).  The sequence forms run the recurrence one step at a time, as
the reference's `lax.scan` does; `mlstm_parallel` is the quadratic form.
The stabiliser `m` starts at -1e30 in the decode inits, as in the
reference (`transformer.init_cache` starts it at 0, also as there).
The sequence forms hand decode the state they reached (`with_state`),
where the reference's prefill hands on the decode init.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


# ---------------------------------------------------------------------- mLSTM

def mlstm_init(gen, cfg, dtype, device, lead=()):
    d, h = cfg.d_model, cfg.n_heads
    lead = tuple(lead)
    return {
        "w_q": dense_init(gen, (d, d), dtype, device, lead=lead),
        "w_k": dense_init(gen, (d, d), dtype, device, lead=lead),
        "w_v": dense_init(gen, (d, d), dtype, device, lead=lead),
        "w_i": dense_init(gen, (d, h), torch.float32, device, lead=lead),
        "w_f": dense_init(gen, (d, h), torch.float32, device, lead=lead),
        "w_o": dense_init(gen, (d, d), dtype, device, lead=lead),
        "w_out": dense_init(gen, (d, d), dtype, device, lead=lead),
        "f_bias": torch.full(lead + (h,), 3.0, dtype=torch.float32,
                             device=device),
    }


def _mlstm_step(state, qkvif):
    c, n, m = state                       # (B,H,hd,hd), (B,H,hd), (B,H)
    q, k, v, ig, fg = qkvif               # q/k/v: (B,H,hd); ig/fg: (B,H)
    m_new = torch.maximum(fg + m, ig)
    i_p = torch.exp(ig - m_new)[..., None]
    f_p = torch.exp(fg + m - m_new)[..., None]
    c = f_p[..., None] * c + i_p[..., None] * (v[..., :, None] * k[..., None, :])
    n = f_p * n + i_p * k
    num = torch.einsum("bhvk,bhk->bhv", c, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    return (c, n, m_new), num / den[..., None]


def _mlstm_proj(x, p, cfg):
    h = cfg.n_heads
    hd = cfg.d_model // h
    shape = x.shape[:-1] + (h, hd)
    q = (x @ p["w_q"]).reshape(shape).float()
    k = (x @ p["w_k"]).reshape(shape).float() * (hd ** -0.5)
    v = (x @ p["w_v"]).reshape(shape).float()
    ig = x.float() @ p["w_i"].float()
    fg = F.logsigmoid(x.float() @ p["w_f"].float() + p["f_bias"])
    return q, k, v, ig, fg


def mlstm_parallel(x, p, cfg):
    """Quadratic (chunk-free) parallel form of the mLSTM recurrence — the
    xLSTM paper's training formulation."""
    b, s, d = x.shape
    q, k, v, ig, fg = _mlstm_proj(x, p, cfg)          # (B,S,H,hd)/(B,S,H)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    ig, fg = ig.transpose(1, 2), fg.transpose(1, 2)   # (B,H,S)
    lcum = torch.cumsum(fg, dim=-1)                   # log forget prefix
    a = ig - lcum
    m = lcum + torch.cummax(a, dim=-1).values         # stabilizer per step
    logd = (lcum[..., :, None] - lcum[..., None, :]
            + ig[..., None, :] - m[..., :, None])     # (B,H,S,S)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=x.device))
    dmat = torch.where(causal, torch.exp(logd), 0.0)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * dmat
    den = torch.maximum(torch.abs(scores.sum(-1)), torch.exp(-m))
    y = torch.einsum("bhqk,bhkd->bhqd", scores / den[..., None], v)
    y = y.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    o = torch.sigmoid(x @ p["w_o"])
    return (y * o) @ p["w_out"]


def mlstm_forward(x, p, cfg, with_state: bool = False):
    """x: (B,S,D) -> (B,S,D); with `with_state`, also the recurrent state
    {'c', 'n', 'm'} after the sequence."""
    if cfg.unroll and not with_state:
        return mlstm_parallel(x, p, cfg)
    b, s, d = x.shape
    q, k, v, ig, fg = _mlstm_proj(x, p, cfg)
    st = mlstm_decode_init(cfg, b, p, x.device)
    state = (st["c"], st["n"], st["m"])
    ys = []
    for t in range(s):
        state, y = _mlstm_step(state, (q[:, t], k[:, t], v[:, t], ig[:, t],
                                       fg[:, t]))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(x.dtype)
    o = torch.sigmoid(x @ p["w_o"])
    out = (y * o) @ p["w_out"]
    if with_state:
        return out, dict(zip(("c", "n", "m"), state))
    return out


def mlstm_decode_init(cfg, batch, p=None, device=None):
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, h, hd, hd), **f32),
        "n": torch.zeros((batch, h, hd), **f32),
        "m": torch.full((batch, h), -1e30, **f32),
    }


def mlstm_decode(x, state, p, cfg):
    q, k, v, ig, fg = _mlstm_proj(x[:, None], p, cfg)
    (c, n, m), y = _mlstm_step(
        (state["c"], state["n"], state["m"]),
        (q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]))
    y = y.reshape(x.shape).to(x.dtype)
    o = torch.sigmoid(x @ p["w_o"])
    return (y * o) @ p["w_out"], {"c": c, "n": n, "m": m}


# ---------------------------------------------------------------------- sLSTM

def slstm_init(gen, cfg, dtype, device, lead=()):
    d = cfg.d_model
    lead = tuple(lead)
    return {
        "w": dense_init(gen, (d, 4 * d), dtype, device, lead=lead),
        "r": dense_init(gen, (d, 4 * d), dtype, device, lead=lead),
        "b": torch.zeros(lead + (4 * d,), dtype=torch.float32,
                         device=device),
        "w_out": dense_init(gen, (d, d), dtype, device, lead=lead),
    }


def _slstm_step(p, state, wx):
    c, n, m, h = state                      # all (B, D) f32
    pre = (wx + h.to(wx.dtype) @ p["r"]).float() + p["b"]
    zi, ii, fi, oi = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    lf = F.logsigmoid(fi)
    m_new = torch.maximum(lf + m, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(lf + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h_new = o * c / torch.clamp(n, min=1.0)
    return (c, n, m_new, h_new), h_new


def slstm_forward(x, p, cfg, with_state: bool = False):
    """x: (B,S,D) -> (B,S,D); with `with_state`, also the recurrent state
    {'c', 'n', 'm', 'h'} after the sequence."""
    b, s, d = x.shape
    wx = x @ p["w"]
    st = slstm_decode_init(cfg, b, p, x.device)
    state = (st["c"], st["n"], st["m"], st["h"])
    ys = []
    for t in range(s):
        state, y = _slstm_step(p, state, wx[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype)
    out = y @ p["w_out"]
    if with_state:
        return out, dict(zip(("c", "n", "m", "h"), state))
    return out


def slstm_decode_init(cfg, batch, p=None, device=None):
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "m": z - 1e30, "h": z.clone()}


def slstm_decode(x, state, p, cfg):
    wx = x @ p["w"]
    (c, n, m, h), y = _slstm_step(
        p, (state["c"], state["n"], state["m"], state["h"]), wx)
    return y.to(x.dtype) @ p["w_out"], {"c": c, "n": n, "m": m, "h": h}
