"""Shared layer primitives: norms, RoPE, MLPs, embeddings, init helpers.

The port of `repro/models/layers.py`.  Every function keeps the
reference's order of casts: `rms_norm` squares in float32, casts back,
and only then scales; `apply_rope` rotates interleaved pairs
(`x[..., 0::2]`, `x[..., 1::2]`) in float32.

The init helpers draw from a `torch.Generator` on its own device and
move the result to `device`, so one seed gives the same weights on the
CPU and on the card.  `lead` is the leading shape of a stack of layers
(the repeats of one pattern position); the scale is that of one layer.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0, fraction: float = 1.0):
    """Rotary embedding over the leading `fraction` of the head dims.

    x: (..., S, H, hd); positions: broadcastable (..., S).
    fraction=0.5 gives the ChatGLM-style 2D/partial rotary.
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    if rot % 2:
        rot -= 1
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = torch.from_numpy(rope_freqs(rot, theta)).to(x.device)  # (rot/2,)
    ang = positions[..., None].float() * freqs            # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def mlp_apply(x, p, kind: str):
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    # jax.nn.gelu is the tanh approximation by default
    h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


def normal(gen: torch.Generator, shape, std, dtype, device):
    """Standard normal draws from `gen` times `std`, as `dtype` on
    `device`.  On the `meta` device, the shape alone: nothing is drawn
    or allocated."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    t = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return t.to(device=device, dtype=dtype)


def dense_init(gen, shape, dtype, device, scale_axis: int = 0, lead=()):
    std = shape[scale_axis] ** -0.5
    return normal(gen, tuple(lead) + tuple(shape), std, dtype, device)


def mlp_init(gen, d_model: int, d_ff: int, kind: str, dtype, device,
             lead=()):
    p = {
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device, lead=lead),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device, lead=lead),
    }
    if kind == "swiglu":
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype, device,
                                 lead=lead)
    return p
