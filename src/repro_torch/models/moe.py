"""Mixture-of-Experts FFN, capacity-bounded, with local routing.

The port of `repro/models/moe.py` (`_moe_local` at one expert a step,
the reference's default).  The reference computes it in plain JAX (no
Pallas kernel), so it is plain torch here.  Its choices are kept where
they decide which token an expert takes:

- the top-k breaks ties toward the lower expert id (`jax.lax.top_k`);
- the assignments are ordered by a *stable* sort on the expert id
  (`jnp.argsort`), so the tokens an expert keeps are its first
  `capacity` in token order and the rest are dropped;
- the capacity is `max(8, ceil8(capacity_factor * n * k / E))`.

Over a mesh the reference routes per data shard inside `shard_map`;
here `local_map` does (`torch.distributed.tensor.experimental`), with
the reference's specs: tokens over the batch axes (replicated when the
batch does not divide, the global_batch=1 decode), expert FFN width
over `model`.  Each model shard's sum over its slice of the FFN width
is a partial sum: the reference's `psum` over `model` is the
redistribution of that `Partial` output to replicated, in float32,
before the cast back.  The experts' parameters are FSDP-sharded over
`data` at rest (`param_specs`), which the local function cannot take:
they are laid out by its specs first (GSPMD did so unasked), one
all-gather a weight a layer, not one an expert (`run_stack` gathers a
repeat's FSDP shards as it starts, so there only `w_down`'s model shards
move).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.sharding import (P, batch_entry, placements,
                                         spec_leaves)
from repro_torch.models.tree import leaves, unflatten


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
    """x: (N, D) tokens; expert weights (E, D, F), or a slice of F.
    Returns the float32 sum (partial over an F slice)."""
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
    # a scatter-add, not `bincount`: its output's shape is static, which
    # a shape-only trace (the dry run) needs
    counts = torch.zeros(e, dtype=flat_ids.dtype, device=x.device
                         ).scatter_add_(0, flat_ids, torch.ones_like(flat_ids))
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
    return acc


def capacity(cfg, n: int) -> int:
    cap = int(math.ceil(cfg.capacity_factor * n * cfg.topk
                        / max(cfg.n_experts, 1)))
    return max(8, -(-cap // 8) * 8)


def _expert_specs(p, tp):
    specs = {"w_router": P(None, None), "w_gate": P(None, None, tp),
             "w_up": P(None, None, tp), "w_down": P(None, tp, None)}
    if "shared" in p:
        specs["shared"] = {"w_gate": P(None, tp), "w_up": P(None, tp),
                           "w_down": P(tp, None)}
    return specs


def moe_ffn(x, p, cfg, ctx):
    """x: (B, S, D). ctx: repro_torch.models.sharding.Ctx (mesh optional)."""
    b, s, d = x.shape

    def run(xl, *leaves_):
        pl_ = unflatten(p, leaves_)
        n = xl.shape[0] * xl.shape[1]
        y = _moe_local(xl.reshape(n, d), pl_, topk=cfg.topk,
                       capacity=capacity(cfg, n))
        return y.reshape(xl.shape)

    if ctx.mesh is None:
        return run(x, *leaves(p)).to(x.dtype)

    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    # global_batch=1 decode: tokens replicate across the batch axes;
    # the expert FFN stays TP-sharded over `model`
    dp = batch_entry(ctx, b)
    mesh = ctx.mesh
    x_spec = P(dp, None, None)
    p_specs = spec_leaves(_expert_specs(p, ctx.tp_axis))
    xs = ctx.constraint(x, x_spec)
    ws = [ctx.constraint(w, sp) for w, sp in zip(leaves(p), p_specs)]
    in_pl = [placements(sp, mesh) for sp in [x_spec] + p_specs]
    # a mesh axis an input is replicated over, whose ranks see different
    # tokens or FFN slices, gets a partial sum of that input's gradient
    split = {ctx.tp_axis} | (set(ctx.dp_axes) if dp is not None else set())

    def grad_pl(pl):
        return tuple(Partial() if isinstance(q, Replicate) and name in split
                     else q for name, q in zip(mesh.mesh_dim_names, pl))

    out_pl = [Partial() if name == ctx.tp_axis else q
              for name, q in zip(mesh.mesh_dim_names, in_pl[0])]
    y = local_map(run, out_placements=out_pl, in_placements=tuple(in_pl),
                  in_grad_placements=tuple(grad_pl(pl) for pl in in_pl),
                  device_mesh=mesh)(xs, *ws)
    return ctx.constraint(y, x_spec).to(x.dtype)
