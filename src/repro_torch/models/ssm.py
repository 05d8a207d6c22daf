"""Mamba-1 selective SSM block (Jamba's sequence mixer).

The port of `repro/models/ssm.py`.  The reference scans chunks of the
sequence with an `associative_scan` inside each (no Pallas kernel); the
port runs the same recurrence, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
one step at a time in float32.  The two add in different orders, so
they agree to float32 rounding (the tests hold them to rtol 1e-4, atol
1e-5), not bit for bit.  Decode is the single-step recurrence, and the
sequence form hands it the state it reached (`with_state`), where the
reference's prefill hands on the zero state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, normal


def mamba_init(gen, cfg, dtype, device, lead=()):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    rank = max(1, d // 16)
    lead = tuple(lead)
    a = torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32)
    return {
        "w_in": dense_init(gen, (d, 2 * di), dtype, device, lead=lead),
        "conv_w": normal(gen, lead + (cfg.ssm_conv, di), 0.1, dtype, device),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "w_xproj": dense_init(gen, (di, rank + 2 * cfg.ssm_state), dtype,
                              device, lead=lead),
        "w_dt": dense_init(gen, (rank, di), dtype, device, lead=lead),
        "dt_bias": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "a_log": torch.log(a).expand(lead + (di, cfg.ssm_state))
        .to(device).clone(),
        "d_skip": torch.ones(lead + (di,), dtype=torch.float32,
                             device=device),
        "w_out": dense_init(gen, (di, d), dtype, device, scale_axis=0,
                            lead=lead),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,di), w: (K,di)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def _ssm_params(x1, p, cfg):
    rank = p["w_dt"].shape[0]
    proj = x1 @ p["w_xproj"]
    dt, bmat, cmat = torch.split(proj, [rank, cfg.ssm_state, cfg.ssm_state],
                                 dim=-1)
    dt = F.softplus(dt @ p["w_dt"] + p["dt_bias"]).float()
    a = -torch.exp(p["a_log"])                                # (di, state)
    return dt, bmat.float(), cmat.float(), a


def mamba_forward(x, p, cfg, with_state: bool = False):
    """x: (B, S, D) -> (B, S, D); with `with_state`, also the decode
    state after the sequence: the scan's last `h` and the conv's input
    tail (its last K-1 rows, zeros before the first token)."""
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    xz = x @ p["w_in"]
    x1, z = torch.chunk(xz, 2, dim=-1)
    k = p["conv_w"].shape[0]
    tail = F.pad(x1, (0, 0, k - 1, 0))[:, s:]
    x1 = F.silu(_causal_conv(x1, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat, a = _ssm_params(x1, p, cfg)
    x1f = x1.float()
    h = torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)                 # (B,di,state)
        dbx = (dt[:, t] * x1f[:, t])[..., None] * bmat[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1)
    y = (y + p["d_skip"] * x1f).to(x.dtype)
    out = (y * F.silu(z)) @ p["w_out"]
    return (out, {"h": h, "conv": tail}) if with_state else out


def mamba_decode_init(cfg, batch, dtype, device=None):
    di = cfg.ssm_expand * cfg.d_model
    return {
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
    }


def mamba_decode(x, state, p, cfg):
    """x: (B, D) one token; state: {'h','conv'} -> (y (B,D), new state)."""
    xz = x @ p["w_in"]
    x1, z = torch.chunk(xz, 2, dim=-1)
    conv_in = torch.cat([state["conv"], x1[:, None]], dim=1)
    x1 = F.silu((conv_in * p["conv_w"]).sum(dim=1) + p["conv_b"])
    dt, bmat, cmat, a = _ssm_params(x1[:, None], p, cfg)
    dt, bmat, cmat = dt[:, 0], bmat[:, 0], cmat[:, 0]
    da = torch.exp(dt[..., None] * a)
    dbx = (dt * x1.float())[..., None] * bmat[:, None, :]
    h = da * state["h"] + dbx
    y = torch.einsum("bds,bs->bd", h, cmat)
    y = (y + p["d_skip"] * x1.float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["w_out"]
    return out, {"h": h, "conv": conv_in[:, 1:]}
