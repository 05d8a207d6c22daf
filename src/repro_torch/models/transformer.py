"""Composable block stacks for all assigned architecture families.

The port of `repro/models/transformer.py`.  A model is `embed -> the
pattern's blocks, repeat after repeat -> final norm -> lm head`.  `LM`
is an `nn.Module` whose parameters are laid out as the reference's tree:
`blocks[j]` is the block kind at position j of the config's `pattern`
(`AttnBlock`, `MLABlock`, `MambaBlock`, `MLSTMBlock`, `SLSTMBlock`),
and each of its tensors carries a leading axis over the pattern's
repeats, so `named_parameters()` maps leaf for leaf onto the reference's
tree (`blocks.0.mixer.w_q` is `params["blocks"][0]["mixer"]["w_q"]`).
The reference scans the repeats with `lax.scan`; here a Python loop
runs them.  Caches are the reference's too: a tuple over pattern
positions of dicts of tensors with the same leading repeat axis.

Modes: train/encode (full sequence), prefill (full sequence + emits KV /
state caches), decode (single token + cache update).  `decode_step`
takes `pos` as an int (every row at one position: the reference's
computation) or as a (B,) tensor: each row then writes its K/V (or its
MLA `ckv`/`kpe`) at its own position and attends over its own prefix.

Every function of the stack reads the parameters as the reference's
tree of tensors (`LM.tree()`), and `run_stack` slices repeat r of each
leaf (`v[r]`) as the reference's scan does.  `forward_train` casts the
float32 masters to the compute dtype differentiably, inside the step as
the reference does, so gradients land on the masters in float32; with
autograd on, each repeat of the pattern is recomputed in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint(rep_body)`),
and the repeat's slices are taken inside the recomputed function.
Serving casts once (`cast_params`), the caller holds the copy, and
`prefill` and `decode_step` run without autograd.

Over a mesh (`Ctx(mesh=...)`, `models/sharding.py`) the parameters are
DTensors laid out by `param_specs`; the entry points place their inputs
by `batch_spec` (and a decode cache by `cache_spec`) and pin the
reference's constraints (the embedding's rows, the vocabulary-sharded
logits).  Where DTensor, unlike GSPMD, cannot be left to choose, the
stack chooses: a repeat's FSDP shards are gathered as it starts, the
residual stream keeps one layout (`_residual`), heads that `model` does
not divide are gathered before they are split, and attention with its
cache writes runs on each rank's rows and heads (`local_call`).
"""
from __future__ import annotations

import functools
import os
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.compile import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, mlp_apply,
                                       mlp_init, rms_norm)
from repro_torch.models.sharding import (Ctx, P, batch_entry,
                                         distribute_batch, distribute_cache,
                                         gather_axes, local_call)
from repro_torch.models.tree import tree_map


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# parameters as modules
# ---------------------------------------------------------------------------

class Params(nn.Module):
    """A dict of tensors (nested dicts become submodules), registered as
    parameters under the reference's names."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        """The reference's dict."""
        out: dict[str, Any] = dict(self._parameters)
        for k, m in self._modules.items():
            out[k] = m.tree()
        return out


def _heads(ctx: Ctx, b: int, h: int, hkv: int):
    """The mesh entries of attention's batch and head dims: each rank
    attends over its rows and, where `model` divides both head counts,
    its heads (its query heads then read only its own KV heads)."""
    heads = (ctx.tp_axis if ctx.mesh is not None and h % ctx.tp_size == 0
             and hkv % ctx.tp_size == 0 else None)
    return batch_entry(ctx, b) if ctx.mesh is not None else None, heads


def _attend(ctx: Ctx, q, k, v, **kw):
    """`blockwise_attention` on each rank's rows and heads: the product
    of two dims sharded over two axes cannot be flattened into one
    batched matmul of DTensors."""
    bd, hd = _heads(ctx, q.shape[0], q.shape[2], k.shape[2])
    spec = P(bd, None, hd, None)
    return local_call(ctx, functools.partial(A.blockwise_attention, **kw),
                      (q, k, v), (spec,) * 3, spec)


def _cross_attn(x, p, ln, enc_kv, cfg, ctx):
    """Cross attention over precomputed encoder K/V."""
    b, s = x.shape[0], x.shape[1]
    h, hd = cfg.n_heads, cfg.hd
    hx = rms_norm(x, ln)
    q = _heads_of(ctx, hx @ p["w_q"], h, hd)
    k, v = enc_kv
    out = _attend(ctx, q, k, v, causal=False)
    return out.reshape(b, s, -1) @ p["w_o"]


def _residual(ctx: Ctx, x, out):
    """`x + out`, over a mesh with `out` summed and laid out as the
    residual stream is (rows over the data axes, replicated over
    `model`) first: a row-parallel product's partial sums are reduced
    here, and every repeat hands the next the layout it took.  This is
    the reference's `REPRO_BLOCK_CONSTRAINT=1` layout, always on: DTensor
    picks each operation's layout alone, where GSPMD solves the program,
    and left free it hands torch 2.11 gradients it cannot add."""
    spec = P(batch_entry(ctx, out.shape[0]), *[None] * (out.ndim - 1))
    return x + ctx.constraint(out, spec)


def _ffn(x, p, cfg, ctx, is_moe):
    h2 = rms_norm(x, p["ln2"])
    if is_moe:
        return MOE.moe_ffn(h2, p["ffn"], cfg, ctx)
    return mlp_apply(h2, p["ffn"], cfg.mlp)


class Block(Params):
    """One pattern position: norm, mixer, optional cross attention and
    FFN, every tensor stacked over the pattern's repeats.  A subclass for
    a mixer kind holds that mixer's init, cache layout, full-sequence
    form and decode step."""

    kind = ""

    def __init__(self, tree: dict, is_moe: bool):
        super().__init__(tree)
        self.is_moe = is_moe

    @classmethod
    def init_tree(cls, gen, cfg, is_moe, dtype, device, lead,
                  cross=False) -> dict:
        ones = lambda: torch.ones(tuple(lead) + (cfg.d_model,), dtype=dtype,
                                  device=device)
        p: dict[str, Any] = {"ln1": ones(),
                             "mixer": cls.mixer_init(gen, cfg, dtype, device,
                                                     lead)}
        if cross:
            p["cross"] = AttnBlock.mixer_init(gen, cfg, dtype, device, lead)
            p["ln_cross"] = ones()
        if cls.kind in ("attn", "mla", "mamba") and (cfg.d_ff > 0 or is_moe):
            p["ln2"] = ones()
            p["ffn"] = (MOE.moe_init(gen, cfg, dtype, device, lead) if is_moe
                        else mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                      dtype, device, lead))
        return p

    def forward(self, x, p, cfg, ctx, *, positions, mode, causal=True,
                cache=None, pos=None, enc_out=None):
        """This position at one repeat, whose tree is `p`.  Returns (x,
        new_cache_dict).  In decode mode `pos` is a (B,) tensor of
        positions."""
        h = rms_norm(x, p["ln1"])
        if mode == "decode":
            new_cache = dict(cache)
            out, st = self.decode(h, p["mixer"], cfg, ctx, cache, pos)
            new_cache.update(st)
            x = _residual(ctx, x, out)
            if "cross" in p:
                out = _cross_attn(x[:, None], p["cross"], p["ln_cross"],
                                  (cache["ck"], cache["cv"]), cfg, ctx)[:, 0]
                x = _residual(ctx, x, out)
            if "ffn" in p:
                x = _residual(ctx, x, _ffn(x[:, None], p, cfg, ctx,
                                           self.is_moe)[:, 0])
            return x, new_cache

        # ---- full-sequence modes (train / encode / prefill) -----------------
        out, new_cache = self.full(h, p["mixer"], cfg, ctx, positions, causal,
                                   mode)
        x = _residual(ctx, x, out)
        if "cross" in p and enc_out is not None:
            hkv, hd = cfg.n_kv_heads, cfg.hd
            k_enc = _heads_of(ctx, enc_out @ p["cross"]["w_k"], hkv, hd)
            v_enc = _heads_of(ctx, enc_out @ p["cross"]["w_v"], hkv, hd)
            x = _residual(ctx, x, _cross_attn(x, p["cross"], p["ln_cross"],
                                              (k_enc, v_enc), cfg, ctx))
            if mode == "prefill":
                new_cache["ck"], new_cache["cv"] = k_enc, v_enc
        if "ffn" in p:
            x = _residual(ctx, x, _ffn(x, p, cfg, ctx, self.is_moe))
        return x, new_cache


def _rope_frac(cfg):
    return {"default": 1.0, "half": 0.5, "none": 0.0}[cfg.rope]


def _ap(t, positions, cfg, fr):
    return apply_rope(t, positions, theta=cfg.rope_theta, fraction=fr)


def _heads_of(ctx: Ctx, t, n: int, hd: int):
    """(B, S, n * hd) as (B, S, n, hd).  Over a mesh whose `model` axis
    does not divide the n heads, the last dim is gathered over it first:
    a shard that cuts a head cannot be split into heads."""
    if ctx.mesh is not None and n % ctx.tp_size:
        t = ctx.constraint(t, P(batch_entry(ctx, t.shape[0]), None, None))
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def _qkv(x, p, cfg, positions, ctx):
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["w_q"] + (p["b_q"] if "b_q" in p else 0)
    k = x @ p["w_k"] + (p["b_k"] if "b_k" in p else 0)
    v = x @ p["w_v"] + (p["b_v"] if "b_v" in p else 0)
    q = _heads_of(ctx, q, h, hd)
    k = _heads_of(ctx, k, hkv, hd)
    v = _heads_of(ctx, v, hkv, hd)
    fr = _rope_frac(cfg)
    if fr > 0:
        q = _ap(q, positions, cfg, fr)
        k = _ap(k, positions, cfg, fr)
    return q, k, v


def _put_rows(cache, pos, new):
    """`cache` (B, Smax, ...) with row b's entry at pos[b] set to new[b]."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put((rows, pos), new.to(cache.dtype))


class AttnBlock(Block):
    kind = "attn"

    @staticmethod
    def mixer_init(gen, cfg, dtype, device, lead):
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        p = {
            "w_q": dense_init(gen, (d, h * hd), dtype, device, lead=lead),
            "w_k": dense_init(gen, (d, hkv * hd), dtype, device, lead=lead),
            "w_v": dense_init(gen, (d, hkv * hd), dtype, device, lead=lead),
            "w_o": dense_init(gen, (h * hd, d), dtype, device, lead=lead),
        }
        if cfg.qkv_bias:
            for name, width in (("b_q", h * hd), ("b_k", hkv * hd),
                                ("b_v", hkv * hd)):
                p[name] = torch.zeros(tuple(lead) + (width,), dtype=dtype,
                                      device=device)
        return p

    @staticmethod
    def cache_struct(cfg, batch, smax, dtype):
        shape = (batch, smax, cfg.n_kv_heads, cfg.hd)
        return {"k": (shape, dtype), "v": (shape, dtype)}

    @staticmethod
    def full(x, p, cfg, ctx, positions, causal, mode):
        window = cfg.window if cfg.attn == "swa" else None
        q, k, v = _qkv(x, p, cfg, positions, ctx)
        out = _attend(ctx, q, k, v, causal=causal, window=window,
                      unroll=cfg.unroll and cfg.attn_impl == "naive")
        out = out.reshape(x.shape[0], x.shape[1], -1) @ p["w_o"]
        return out, ({"k": k, "v": v} if mode == "prefill" else {})

    @staticmethod
    def decode(x, p, cfg, ctx, cache, pos):
        b = x.shape[0]
        q, k, v = _qkv(x[:, None], p, cfg, pos[:, None], ctx)
        window = cfg.window if cfg.attn == "swa" else None

        def step(q, k, v, k_cache, v_cache, pos):
            k_cache = _put_rows(k_cache, pos, k)
            v_cache = _put_rows(v_cache, pos, v)
            return (A.decode_attention(q, k_cache, v_cache, pos + 1,
                                       window=window), k_cache, v_cache)

        # over a mesh each rank writes and reads its own rows and heads
        bd, hd = _heads(ctx, b, cfg.n_heads, cfg.n_kv_heads)
        one, kv = P(bd, hd, None), P(bd, None, hd, None)
        out, k_cache, v_cache = local_call(
            ctx, step, (q[:, 0], k[:, 0], v[:, 0], cache["k"], cache["v"],
                        pos), (one, one, one, kv, kv, P(bd)), (one, kv, kv))
        out = out.reshape(b, -1) @ p["w_o"]
        return out, {"k": k_cache, "v": v_cache}


def _mla_proj_q(x, p, cfg):
    b, s = x.shape[0], x.shape[1]
    h, nope, rd = cfg.n_heads, cfg.hd, cfg.rope_dim
    cq = rms_norm(x @ p["w_dq"], p["q_ln"])
    q = (cq @ p["w_uq"]).reshape(b, s, h, nope + rd)
    return q[..., :nope], q[..., nope:]


class MLABlock(Block):
    kind = "mla"

    @staticmethod
    def mixer_init(gen, cfg, dtype, device, lead):
        d, h = cfg.d_model, cfg.n_heads
        nope, rd, dv = cfg.hd, cfg.rope_dim, cfg.v_head_dim
        return {
            "w_dq": dense_init(gen, (d, cfg.q_lora), dtype, device,
                               lead=lead),
            "q_ln": torch.ones(tuple(lead) + (cfg.q_lora,), dtype=dtype,
                               device=device),
            "w_uq": dense_init(gen, (cfg.q_lora, h * (nope + rd)), dtype,
                               device, lead=lead),
            "w_dkv": dense_init(gen, (d, cfg.kv_lora + rd), dtype, device,
                                lead=lead),
            "kv_ln": torch.ones(tuple(lead) + (cfg.kv_lora,), dtype=dtype,
                                device=device),
            "w_uk": dense_init(gen, (cfg.kv_lora, h, nope), dtype, device,
                               lead=lead),
            "w_uv": dense_init(gen, (cfg.kv_lora, h, dv), dtype, device,
                               lead=lead),
            "w_o": dense_init(gen, (h * dv, d), dtype, device, lead=lead),
        }

    @staticmethod
    def cache_struct(cfg, batch, smax, dtype):
        return {"ckv": ((batch, smax, cfg.kv_lora), dtype),
                "kpe": ((batch, smax, cfg.rope_dim), dtype)}

    @staticmethod
    def full(x, p, cfg, ctx, positions, causal, mode):
        b, s = x.shape[0], x.shape[1]
        h, rd = cfg.n_heads, cfg.rope_dim
        q_nope, q_pe = _mla_proj_q(x, p, cfg)
        q_pe = _ap(q_pe, positions, cfg, 1.0)
        ckv_full = x @ p["w_dkv"]
        ckv, kpe = ckv_full[..., :cfg.kv_lora], ckv_full[..., cfg.kv_lora:]
        ckv_n = rms_norm(ckv, p["kv_ln"])
        kpe = _ap(kpe[:, :, None, :], positions, cfg, 1.0)[:, :, 0]
        k_nope = torch.einsum("bsl,lhn->bshn", ckv_n, p["w_uk"])
        v = torch.einsum("bsl,lhn->bshn", ckv_n, p["w_uv"])
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, kpe[:, :, None].expand(b, s, h, rd)], dim=-1)
        out = _attend(ctx, q, k, v, causal=causal,
                      unroll=cfg.unroll and cfg.attn_impl == "naive")
        out = out.reshape(b, s, -1) @ p["w_o"]
        return out, ({"ckv": ckv_n, "kpe": kpe} if mode == "prefill"
                     else {})

    @staticmethod
    def decode(x, p, cfg, ctx, cache, pos):
        b = x.shape[0]
        nope, rd = cfg.hd, cfg.rope_dim
        positions = pos[:, None]
        q_nope, q_pe = _mla_proj_q(x[:, None], p, cfg)
        q_pe = _ap(q_pe, positions, cfg, 1.0)[:, 0]
        q_nope = q_nope[:, 0]
        ckv_full = x @ p["w_dkv"]
        ckv, kpe = ckv_full[..., :cfg.kv_lora], ckv_full[..., cfg.kv_lora:]
        ckv_n = rms_norm(ckv, p["kv_ln"])
        kpe = _ap(kpe[:, None, None, :], positions, cfg, 1.0)[:, 0, 0]
        ckv_cache = _put_rows(cache["ckv"], pos, ckv_n)
        kpe_cache = _put_rows(cache["kpe"], pos, kpe)
        # absorbed attention against the compressed cache
        q_abs = torch.einsum("bhn,lhn->bhl", q_nope.float(),
                             p["w_uk"].float())
        w = A.mla_decode_scores(q_abs, q_pe.float(), ckv_cache.float(),
                                kpe_cache.float(), pos + 1,
                                (nope + rd) ** -0.5)
        out_c = torch.einsum("bhk,bkl->bhl", w, ckv_cache.float())
        out = torch.einsum("bhl,lhn->bhn", out_c, p["w_uv"].float())
        # over a mesh the heads' values may come out sharded on their own
        # dim, which flattening the heads cannot keep: rows only
        out = ctx.constraint(out, P(batch_entry(ctx, b), None, None))
        out = out.reshape(b, -1).to(x.dtype) @ p["w_o"]
        return out, {"ckv": ckv_cache, "kpe": kpe_cache}


class MambaBlock(Block):
    kind = "mamba"
    mixer_init = staticmethod(SSM.mamba_init)

    @staticmethod
    def cache_struct(cfg, batch, smax, dtype):
        di = cfg.ssm_expand * cfg.d_model
        return {"h": ((batch, di, cfg.ssm_state), torch.float32),
                "conv": ((batch, cfg.ssm_conv - 1, di), dtype)}

    @staticmethod
    def full(x, p, cfg, ctx, positions, causal, mode):
        # prefill hands decode the state after the prompt (the
        # reference's hands on the zero state; ROADMAP Queue 3)
        if mode == "prefill":
            return SSM.mamba_forward(x, p, cfg, with_state=True)
        return SSM.mamba_forward(x, p, cfg), {}

    @staticmethod
    def decode(x, p, cfg, ctx, cache, pos):
        return SSM.mamba_decode(x, {"h": cache["h"], "conv": cache["conv"]},
                                p, cfg)


class MLSTMBlock(Block):
    kind = "mlstm"
    mixer_init = staticmethod(XL.mlstm_init)

    @staticmethod
    def cache_struct(cfg, batch, smax, dtype):
        h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
        return {"c": ((batch, h, hd, hd), torch.float32),
                "n": ((batch, h, hd), torch.float32),
                "m": ((batch, h), torch.float32)}

    @staticmethod
    def full(x, p, cfg, ctx, positions, causal, mode):
        if mode == "prefill":
            return XL.mlstm_forward(x, p, cfg, with_state=True)
        return XL.mlstm_forward(x, p, cfg), {}

    @staticmethod
    def decode(x, p, cfg, ctx, cache, pos):
        return XL.mlstm_decode(x, {k: cache[k] for k in ("c", "n", "m")},
                               p, cfg)


class SLSTMBlock(Block):
    kind = "slstm"
    mixer_init = staticmethod(XL.slstm_init)

    @staticmethod
    def cache_struct(cfg, batch, smax, dtype):
        f32 = ((batch, cfg.d_model), torch.float32)
        return {"c": f32, "n": f32, "m": f32, "h": f32}

    @staticmethod
    def full(x, p, cfg, ctx, positions, causal, mode):
        if mode == "prefill":
            return XL.slstm_forward(x, p, cfg, with_state=True)
        return XL.slstm_forward(x, p, cfg), {}

    @staticmethod
    def decode(x, p, cfg, ctx, cache, pos):
        return XL.slstm_decode(x, {k: cache[k] for k in ("c", "n", "m", "h")},
                               p, cfg)


BLOCKS: dict[str, type[Block]] = {
    b.kind: b for b in (AttnBlock, MLABlock, MambaBlock, MLSTMBlock,
                        SLSTMBlock)}


def _block_class(kind: str) -> type[Block]:
    if kind not in BLOCKS:
        raise ValueError(kind)
    return BLOCKS[kind]


class Encoder(nn.Module):
    def __init__(self, tree: dict):
        super().__init__()
        self.blocks = nn.ModuleList([AttnBlock(t, False)
                                     for t in tree["blocks"]])
        self.final_norm = nn.Parameter(tree["final_norm"])


class LM(nn.Module):
    """The model's parameters, as modules, in the reference's layout.
    `tree()` gives the reference's parameter tree back."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        _, _, moe_flags = _pattern_info(cfg)
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        if "lm_head" in tree:
            self.lm_head = nn.Parameter(tree["lm_head"])
        self.blocks = nn.ModuleList([
            _block_class(kind)(tree["blocks"][j], moe_flags[j])
            for j, kind in enumerate(cfg.pattern)])
        if "encoder" in tree:
            self.encoder = Encoder(tree["encoder"])

    def tree(self) -> dict:
        out: dict[str, Any] = {"embed": self.embed,
                               "final_norm": self.final_norm,
                               "blocks": tuple(b.tree() for b in self.blocks)}
        if hasattr(self, "lm_head"):
            out["lm_head"] = self.lm_head
        if hasattr(self, "encoder"):
            out["encoder"] = {
                "blocks": tuple(b.tree() for b in self.encoder.blocks),
                "final_norm": self.encoder.final_norm}
        return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _pattern_info(cfg: ModelConfig):
    plen = len(cfg.pattern)
    if cfg.n_layers % plen:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not tile "
                         f"a pattern of {plen}")
    reps = cfg.n_layers // plen
    moe_flags = [cfg.is_moe_layer(j) for j in range(plen)]
    return plen, reps, moe_flags


def init_tree(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """A random parameter tree with the reference's shapes, dtypes and
    scales, drawn from `gen`."""
    dtype = dtype_of(cfg.param_dtype)
    plen, reps, moe_flags = _pattern_info(cfg)
    cross = cfg.encoder_layers > 0
    tree: dict[str, Any] = {
        "blocks": tuple(
            _block_class(cfg.pattern[j]).init_tree(
                gen, cfg, moe_flags[j], dtype, device, (reps,), cross=cross)
            for j in range(plen)),
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype, device),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype,
                                     device)
    if cfg.encoder_layers > 0:
        tree["encoder"] = {
            "blocks": (AttnBlock.init_tree(gen, cfg, False, dtype, device,
                                           (cfg.encoder_layers,)),),
            "final_norm": torch.ones(cfg.d_model, dtype=dtype,
                                     device=device),
        }
    return tree


# ---------------------------------------------------------------------------
# cache structure
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, batch: int, smax: int,
                 s_enc: int = 0) -> tuple:
    """A tuple over pattern positions of dicts of (shape, dtype): the
    decode cache, with the leading repeat axis."""
    plen, reps, _ = _pattern_info(cfg)
    dtype = dtype_of(cfg.dtype)
    out = []
    for j in range(plen):
        c = _block_class(cfg.pattern[j]).cache_struct(cfg, batch, smax, dtype)
        if cfg.encoder_layers > 0:
            shape = (batch, s_enc, cfg.n_kv_heads, cfg.hd)
            c["ck"], c["cv"] = (shape, dtype), (shape, dtype)
        out.append({k: ((reps,) + shape, dt) for k, (shape, dt) in c.items()})
    return tuple(out)


def init_cache(cfg: ModelConfig, batch: int, smax: int, s_enc: int = 0,
               device=None):
    """The zero decode cache of `cache_struct`, on `device` (default: the
    CUDA card, which raises when there is none)."""
    device = resolve_device(device, "init_cache")
    return tuple({k: torch.zeros(shape, dtype=dt, device=device)
                  for k, (shape, dt) in c.items()}
                 for c in cache_struct(cfg, batch, smax, s_enc))


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------

def run_stack(x, blocks, trees, cfg: ModelConfig, ctx: Ctx, *, positions,
              mode, causal=True, caches=None, pos=None, enc_out=None,
              remat=False):
    """Every repeat of the blocks' pattern in turn (the reference's
    `lax.scan` over repeats); `trees[j]` is block j's tree, stacked over
    repeats.  With `remat` and autograd on, each repeat is recomputed in
    the backward.  Returns x and, for prefill and decode, the new caches
    stacked over repeats."""
    reps = trees[0]["ln1"].shape[0]

    def rep_body(x, r, rep_caches):
        new = []
        for j, blk in enumerate(blocks):
            # over a mesh, the repeat's FSDP shards are gathered here, a
            # weight at a time (ZeRO-3): no product contracts over the
            # data axes
            p = tree_map(lambda t: gather_axes(t[r], ctx.dp_axes), trees[j])
            x, nc = blk(x, p, cfg, ctx, positions=positions, mode=mode,
                        causal=causal,
                        cache=rep_caches[j] if rep_caches else None,
                        pos=pos, enc_out=enc_out)
            new.append(nc)
        return x, new

    outs = []
    for r in range(reps):
        rep_caches = ([{k: v[r] for k, v in c.items()} for c in caches]
                      if caches is not None else None)
        if remat and torch.is_grad_enabled():
            x, new = checkpoint(rep_body, x, r, rep_caches,
                                use_reentrant=False)
        else:
            x, new = rep_body(x, r, rep_caches)
        outs.append(new)
    if caches is None and mode != "prefill":
        return x, None
    return x, tuple({k: torch.stack([o[j][k] for o in outs])
                     for k in outs[0][j]} for j in range(len(blocks)))


def _lookup(table, tokens, cfg, ctx: Ctx):
    """Rows of the embedding table.  A table FSDP-sharded over its
    vocabulary is gathered whole along it first (a lookup across
    vocabulary shards is a masked partial sum, which DTensor carries
    only in part)."""
    return F.embedding(tokens, gather_axes(table, ctx.dp_axes)).to(
        dtype_of(cfg.dtype))


def _embed(tree, tokens, cfg, ctx: Ctx, batch_extra=None):
    x = _lookup(tree["embed"], tokens, cfg, ctx)
    if batch_extra is not None:       # vlm patches / prepended embeddings
        x = torch.cat([batch_extra.to(x.dtype), x], dim=1)
    return ctx.constraint(x, P(batch_entry(ctx, x.shape[0]), None, None))


def _logits(tree, x, cfg, ctx: Ctx):
    x = rms_norm(x, tree["final_norm"])
    head = tree["lm_head"] if "lm_head" in tree else tree["embed"].T
    head = gather_axes(head, ctx.dp_axes)     # its FSDP shards, as a block's
    if os.environ.get("REPRO_HEAD_RESHARD") == "1" and ctx.mesh is not None:
        # a tied head contracts over D, which the embedding shards over
        # `model`: move the weight's shards onto the vocabulary instead,
        # so the logits come out model-sharded with no partial sum
        head = ctx.constraint(head, P(None, ctx.tp_axis))
    return ctx.constraint(x @ head, P(batch_entry(ctx, x.shape[0]), None,
                                      ctx.tp_axis))


def _encode(params: LM, tree, frames, cfg, ctx):
    positions = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(dtype_of(cfg.dtype))
    enc = tree["encoder"]
    x, _ = run_stack(x, params.encoder.blocks, enc["blocks"], cfg, ctx,
                     positions=positions, mode="encode", causal=False)
    return rms_norm(x, enc["final_norm"])


def _cast_tree(tree, dtype: torch.dtype):
    """Every float leaf in `dtype`, differentiably (the reference's
    `cast_params`): gradients flow back to the leaves given."""
    return tree_map(lambda t: t.to(dtype)
                    if t.is_floating_point() and t.dtype != dtype else t, tree)


def cast_params(params: LM, cfg: ModelConfig, device=None) -> LM:
    """The model with every float tensor in the compute dtype, on
    `device` (default: the model's), for serving.  The model itself when
    it already is; else a new copy, detached from the masters, which the
    caller holds for every step."""
    dt = dtype_of(cfg.dtype)
    device = torch.device(device) if device is not None \
        else params.embed.device
    if all(p.dtype == dt and p.device == device
           for p in params.parameters()):
        return params
    return LM(cfg, tree_map(lambda t: t.detach().to(device=device, dtype=dt),
                            params.tree()))


def _batch_on(batch, device, ctx: Ctx):
    """The inputs on `device`, placed by `batch_spec` over a mesh."""
    return distribute_batch({k: torch.as_tensor(v, device=device)
                             for k, v in batch.items()}, ctx)


def forward_train(params: LM, batch, cfg: ModelConfig, ctx: Ctx):
    """batch: {'tokens': (B,S) ints, optional 'patch_embeds', 'frames'}.
    Returns the logits (B, S[+patches], V).  The float32 masters are cast
    to the compute dtype inside, differentiably, and each repeat is
    recomputed in the backward."""
    tree = _cast_tree(params.tree(), dtype_of(cfg.dtype))
    batch = _batch_on(batch, params.embed.device, ctx)
    enc_out = None
    if cfg.encoder_layers > 0:
        enc_out = _encode(params, tree, batch["frames"], cfg, ctx)
    x = _embed(tree, batch["tokens"], cfg, ctx, batch.get("patch_embeds"))
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = run_stack(x, params.blocks, tree["blocks"], cfg, ctx,
                     positions=positions, mode="train", causal=True,
                     enc_out=enc_out, remat=True)
    return _logits(tree, x, cfg, ctx)


@torch.no_grad()
def prefill(params: LM, batch, cfg: ModelConfig, ctx: Ctx):
    """Returns the last position's logits (B, V) and the caches."""
    params = cast_params(params, cfg)
    tree = params.tree()
    batch = _batch_on(batch, params.embed.device, ctx)
    enc_out = None
    if cfg.encoder_layers > 0:
        enc_out = _encode(params, tree, batch["frames"], cfg, ctx)
    x = _embed(tree, batch["tokens"], cfg, ctx, batch.get("patch_embeds"))
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = run_stack(x, params.blocks, tree["blocks"], cfg, ctx,
                          positions=positions, mode="prefill", causal=True,
                          enc_out=enc_out)
    logits = _logits(tree, x[:, -1:], cfg, ctx)
    return logits[:, 0], caches


def pad_cache(cache, smax: int):
    """`prefill`'s caches grown to `smax` positions, the layout of
    `init_cache(cfg, B, smax)`: the sequence axis of every KV and MLA
    entry zero-padded at its end, the recurrent states as they are."""
    def grow(k, t):
        if k not in ("k", "v", "ckv", "kpe"):
            return t
        shape = list(t.shape)
        shape[2] = smax - shape[2]
        # zeros laid out as `t` (a DTensor's placements too)
        zeros = torch.zeros_like(t.narrow(2, 0, 1)).expand(shape)
        return torch.cat([t, zeros], dim=2)

    return tuple({k: grow(k, t) for k, t in c.items()} for c in cache)


def _cache_len(cache) -> int | None:
    """The sequence length of the first KV (or MLA) cache, if any."""
    for c in cache:
        for k in ("k", "ckv"):
            if k in c:
                return c[k].shape[2]
    return None


def positions_of(pos, batch: int, device, smax: int | None = None):
    """`pos` (an int, or one position a row) as a (B,) int64 tensor on
    `device`.  A position given on the host is checked against `smax`."""
    t = torch.as_tensor(pos, dtype=torch.int64)
    if t.device.type == "cpu" and smax is not None and t.numel() and (
            int(t.min()) < 0 or int(t.max()) >= smax):
        raise IndexError(f"decode position {pos} outside a cache of {smax}")
    return t.to(device).expand(batch) if t.ndim == 0 else t.to(device)


@torch.no_grad()
def decode_step(params: LM, token, cache, pos, cfg: ModelConfig, ctx: Ctx):
    """token: (B,) ints; pos: an int, or a (B,) tensor of each row's
    position; cache: from `init_cache` (or `prefill`).  Returns (logits
    (B, V), new cache); the given cache is not changed."""
    params = cast_params(params, cfg)
    tree = params.tree()
    device = params.embed.device
    token = torch.as_tensor(token, device=device)
    b = token.shape[0]
    pos = positions_of(pos, b, device, _cache_len(cache))
    if ctx.mesh is not None:
        token = ctx.constraint(token, P(batch_entry(ctx, b)))
        cache = distribute_cache(cache, b, ctx)
    x = _lookup(tree["embed"], token, cfg, ctx)
    x, new_cache = run_stack(x, params.blocks, tree["blocks"], cfg, ctx,
                             positions=None, mode="decode", causal=True,
                             caches=cache, pos=pos)
    logits = _logits(tree, x[:, None], cfg, ctx)[:, 0]
    return logits, new_cache
