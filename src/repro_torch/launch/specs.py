"""Shape-only stand-ins and shardings for every (arch × shape) cell: the
port of `repro/launch/specs.py`.

Nothing here allocates: parameters are `init_params`' tree on the
`meta` device (`layers.normal` draws nothing there), inputs and caches
are `meta` tensors of the reference's shapes and dtypes.  The dry run
(`launch/dryrun.py`) turns them into fake tensors and places them by the
shardings below.  A sharding is a tree of placements, one a mesh
dimension (`models.sharding.placements`).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.sharding import (Ctx, P, batch_spec, cache_spec,
                                         param_specs, placements,
                                         shardings_for)
from repro_torch.models.transformer import cache_struct, init_tree


def sds(shape, dtype):
    """A shape-and-dtype stand-in (`jax.ShapeDtypeStruct`'s place)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def params_struct(cfg: ModelConfig) -> dict:
    """The parameter tree of `cfg` on the `meta` device."""
    return init_tree(cfg, torch.Generator(), "meta")


def param_shardings(struct, ctx: Ctx):
    return shardings_for(struct, ctx)


def _extras_struct(cfg: ModelConfig, b: int, s: int) -> dict[str, Any]:
    out = {}
    if cfg.encoder_layers:
        out["frames"] = sds((b, max(s // 4, 8), cfg.d_model), torch.bfloat16)
    if cfg.n_patches:
        out["patch_embeds"] = sds((b, cfg.n_patches, cfg.d_model),
                                  torch.bfloat16)
    return out


def batch_struct(cfg: ModelConfig, shape: ShapeConfig, *, train: bool):
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": sds((b, s), torch.int32)}
    if train:
        out["targets"] = sds((b, s), torch.int32)
    out.update(_extras_struct(cfg, b, s))
    return out


def batch_specs(batch, ctx: Ctx) -> dict:
    """Each input's spec: its leading (batch) dim over the data axes."""
    return {k: P(batch_spec(ctx), *[None] * (x.ndim - 1))
            for k, x in batch.items()}


def batch_shardings(batch, ctx: Ctx) -> dict:
    return {k: placements(s, ctx.mesh)
            for k, s in batch_specs(batch, ctx).items()}


def decode_structs(cfg: ModelConfig, shape: ShapeConfig):
    b, s = shape.global_batch, shape.seq_len
    s_enc = max(s // 4, 8) if cfg.encoder_layers else 0
    token = sds((b,), torch.int32)
    pos = sds((), torch.int32)
    cache = tuple({k: sds(shp, dt) for k, (shp, dt) in c.items()}
                  for c in cache_struct(cfg, b, s, s_enc))
    return token, pos, cache


def cache_specs(cache, batch: int, ctx: Ctx) -> tuple:
    return tuple({k: cache_spec(tuple(x.shape), batch, ctx)
                  for k, x in c.items()} for c in cache)


def cache_shardings(cache, batch: int, ctx: Ctx) -> tuple:
    return tuple({k: placements(s, ctx.mesh) for k, s in c.items()}
                 for c in cache_specs(cache, batch, ctx))


def cell(arch: str, shape_name: str):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    return cfg, shape


__all__ = ["sds", "params_struct", "param_specs", "param_shardings",
           "batch_struct", "batch_specs", "batch_shardings",
           "decode_structs", "cache_specs", "cache_shardings", "cell"]
