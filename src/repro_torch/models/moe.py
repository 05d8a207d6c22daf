"""Mixture-of-Experts FFN, capacity-bounded, on one device.

The port of `repro/models/moe.py`'s local path (`_moe_local` at one
expert a step, the reference's default).  The reference computes it in
plain JAX (no Pallas kernel), so it is plain torch here.  Its choices
are kept where they decide which token an expert takes:

- the top-k breaks ties toward the lower expert id (`jax.lax.top_k`);
- the assignments are ordered by a *stable* sort on the expert id
  (`jnp.argsort`), so the tokens an expert keeps are its first
  `capacity` in token order and the rest are dropped;
- the capacity is `max(8, ceil8(capacity_factor * n * k / E))`.

The reference's `shard_map` branch over a mesh waits for the GSPMD
slice (ROADMAP Queue 1, item 7c).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def moe_init(gen, cfg, dtype, device, lead=()):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    p = {
        "w_router": dense_init(gen, (d, e), torch.float32, device,
                               lead=lead),
        "w_gate": dense_init(gen, (e, d, f), dtype, device, scale_axis=1,
                             lead=lead),
        "w_up": dense_init(gen, (e, d, f), dtype, device, scale_axis=1,
                           lead=lead),
        "w_down": dense_init(gen, (e, f, d), dtype, device, scale_axis=1,
                             lead=lead),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff)
        p["shared"] = {
            "w_gate": dense_init(gen, (d, fs), dtype, device, lead=lead),
            "w_up": dense_init(gen, (d, fs), dtype, device, lead=lead),
            "w_down": dense_init(gen, (fs, d), dtype, device, lead=lead),
        }
    return p


def top_k(x, k: int):
    """`jax.lax.top_k` over the last axis: the k largest, ties to the
    lower index (a stable descending sort)."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _moe_local(x, p, *, topk: int, capacity: int):
    """x: (N, D) tokens; expert weights (E, D, F)."""
    n, d = x.shape
    e = p["w_router"].shape[1]
    logits = x.float() @ p["w_router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, ids = top_k(probs, topk)                          # (N, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    flat_ids = ids.reshape(-1)                                # (N*k,)
    flat_tok = torch.arange(n, device=x.device).repeat_interleave(topk)
    flat_w = gate_w.reshape(-1).float()
    order = torch.argsort(flat_ids, stable=True)
    s_ids = F.pad(flat_ids[order], (0, capacity), value=-1)
    s_tok = F.pad(flat_tok[order], (0, capacity))
    s_w = F.pad(flat_w[order], (0, capacity))
    counts = torch.bincount(flat_ids, minlength=e)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    # each expert's window of `capacity` sorted assignments (the
    # reference's dynamic_slice at offsets[e]; never past the padding)
    rows = offsets[:e, None] + torch.arange(capacity, device=x.device)
    win_tok, win_ids, win_w = s_tok[rows], s_ids[rows], s_w[rows]

    acc = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for j in range(e):
        idx, w = win_tok[j], win_w[j]
        valid = win_ids[j] == j
        xe = x[idx] * valid[:, None].to(x.dtype)
        h = F.silu(xe @ p["w_gate"][j]) * (xe @ p["w_up"][j])
        y = (h @ p["w_down"][j]).float() * (w * valid)[:, None]
        acc.index_add_(0, idx, y)

    if "shared" in p:
        sp = p["shared"]
        h = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        acc = acc + (h @ sp["w_down"]).float()
    return acc.to(x.dtype)


def capacity(cfg, n: int) -> int:
    cap = int(math.ceil(cfg.capacity_factor * n * cfg.topk
                        / max(cfg.n_experts, 1)))
    return max(8, -(-cap // 8) * 8)


def moe_ffn(x, p, cfg, ctx):
    """x: (B, S, D). ctx: repro_torch.models.sharding.Ctx (one device)."""
    b, s, d = x.shape
    n = b * s
    y = _moe_local(x.reshape(n, d), p, topk=cfg.topk,
                   capacity=capacity(cfg, n))
    return y.reshape(x.shape)
