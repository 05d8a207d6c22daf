"""Sharding context and partition specs: the port of
`repro/models/sharding.py`.

Parallelism layout (the reference's):
  * TP   — last dim of every weight matrix over `model` (heads / FFN hidden
           / expert FFN / vocab);
  * FSDP — second-to-last dim over the batch axes (`pod`+`data`): params and
           optimizer state live sharded and are all-gathered per layer
           where a product needs them (ZeRO-3);
  * DP   — batch over (`pod`,`data`).

Specs are rule-based on leaf shapes with divisibility guards, so the same
code shards a 236B MoE and a 125M SSM; KV caches get explicit specs
(batch→data, kv-heads→model, falling back to sequence→data for the
global_batch=1 long-context cell).

The reference places the specs with GSPMD; here they place `DTensor`s
over a `DeviceMesh` (`torch.distributed.tensor`).  A spec is `P`: one
entry a tensor dimension, each `None`, a mesh axis name or a tuple of
axis names, like JAX's `PartitionSpec`.  `placements(spec, mesh)` turns
it into one placement a mesh dimension (`Shard(d)` where the spec names
the axis at dimension d, else `Replicate()`); `Ctx.constraint` is the
reference's `with_sharding_constraint`, a `redistribute` to the spec's
placements.  The rules read only the mesh's axis names and sizes.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional

import torch

from repro_torch.models.tree import as_tree


class P(tuple):
    """A partition spec: `P("data", None, "model")`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (or anything with
    `mesh_dim_names` and `shape`)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass
class Ctx:
    mesh: Optional[Any] = None
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else axis_sizes(self.mesh)[self.tp_axis]

    def constraint(self, x, spec: P):
        """`x` laid out by `spec` on the mesh (a `redistribute`); the
        identity without a mesh."""
        if self.mesh is None:
            return x
        return place(x, self.mesh, spec)


def placements(spec: P, mesh) -> tuple:
    """One placement a mesh dimension for `spec`."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def place(x, mesh, spec: P):
    """`x` as a DTensor on `mesh` laid out by `spec`: a DTensor is
    redistributed, a plain tensor (the same on every rank) is split.

    A partial sum bound for a shard is summed whole first (an all-reduce,
    then each rank keeps its part) rather than reduce-scattered: the
    gradient of a reduce-scatter is a shard made partial, which the
    DTensor of torch 2.11 cannot redistribute."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          distribute_tensor)

    pl = placements(spec, mesh)
    if not isinstance(x, DTensor):
        return distribute_tensor(x, mesh, pl)
    if tuple(x.placements) == pl:
        return x
    summed = tuple(Replicate() if isinstance(q, Partial) else q
                   for q in x.placements)
    if summed != tuple(x.placements) and summed != pl:
        x = x.redistribute(mesh, summed)
    return x.redistribute(mesh, pl)


def gather_axes(x, axes):
    """`x` with its shards over the mesh `axes` gathered (replicated
    there), its other placements kept; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    pl = tuple(Replicate() if isinstance(q, Shard) and name in axes else q
               for name, q in zip(x.device_mesh.mesh_dim_names,
                                  x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh,
                                                              pl)


def leaf_spec(shape: tuple[int, ...], ctx: Ctx, *, stacked: bool) -> P:
    """Generic FSDP+TP spec for a parameter leaf.

    REPRO_NO_FSDP=1 disables the data-axis (ZeRO) sharding — the right
    call for small models where the per-layer param all-gather costs more
    than the replicated-param memory."""
    if ctx.mesh is None:
        return P()
    nd = len(shape)
    spec: list = [None] * nd
    lo = 1 if stacked else 0       # leading layer-stack dim never sharded
    if nd - lo >= 1 and shape[-1] % ctx.tp_size == 0 \
            and shape[-1] >= ctx.tp_size * 8:
        spec[-1] = ctx.tp_axis
    if (os.environ.get("REPRO_NO_FSDP") != "1" and nd - lo >= 2
            and shape[-2] % ctx.dp_size == 0
            and shape[-2] >= ctx.dp_size * 8):
        spec[-2] = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]
    return P(*spec)


def param_specs(params, ctx: Ctx):
    """A tree of `P` matching `params` (an `LM` or its tree; leaves are
    tensors or anything with a `shape`).  Leaves under 'blocks' are
    layer-stacked (leading reps axis)."""

    def rec(tree, stacked: bool):
        if isinstance(tree, dict):
            return {k: rec(v, stacked or k == "blocks")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return tuple(rec(v, stacked) for v in tree)
        if hasattr(tree, "shape"):
            return leaf_spec(tuple(tree.shape), ctx, stacked=stacked)
        return P()

    return rec(as_tree(params), False)


def _spec_map(fn, specs):
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and not isinstance(specs, P):
        return tuple(_spec_map(fn, v) for v in specs)
    return fn(specs)


def spec_leaves(specs) -> list:
    """The `P` leaves of a tree of specs, in `tree.leaves` order (dict
    keys sorted)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, tuple) and not isinstance(specs, P):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def shardings_for(params, ctx: Ctx):
    """A tree of placements (one a mesh dimension) matching `params`;
    None without a mesh."""
    if ctx.mesh is None:
        return None
    return _spec_map(lambda s: placements(s, ctx.mesh),
                     param_specs(params, ctx))


def batch_spec(ctx: Ctx):
    """The spec *entry* for the batch dimension (str or tuple)."""
    return ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]


def batch_entry(ctx: Ctx, batch: int):
    """`batch_spec` for a batch the data axes divide, else None: a batch
    of 1 (the long-context decode) replicates over them."""
    return batch_spec(ctx) if batch % ctx.dp_size == 0 else None


def cache_spec(shape: tuple[int, ...], batch: int, ctx: Ctx) -> P:
    """KV/state cache leaf spec: (R, B, S, heads, hd)-style layouts.

    Batch shards over dp when divisible; otherwise (global_batch=1 long
    context) the longest remaining dim shards over dp.  Head-like dims
    shard over model when divisible."""
    if ctx.mesh is None:
        return P()
    nd = len(shape)
    spec: list = [None] * nd
    dp = batch_spec(ctx)
    dp_used = False
    if nd >= 2 and shape[1] == batch and batch % ctx.dp_size == 0:
        spec[1] = dp
        dp_used = True
    # model axis on the largest remaining divisible dim (prefer later dims:
    # heads / feature); fall back dp onto sequence for batch=1 cells.
    for i in range(nd - 1, 1, -1):
        if spec[i] is None and shape[i] % ctx.tp_size == 0 \
                and shape[i] >= ctx.tp_size:
            spec[i] = ctx.tp_axis
            break
    if not dp_used:
        # shard the longest unsharded dim (the sequence) over dp
        cand = max((i for i in range(1, nd) if spec[i] is None),
                   key=lambda i: shape[i], default=None)
        if cand is not None and shape[cand] % ctx.dp_size == 0:
            spec[cand] = dp
    return P(*spec)


# ---------------------------------------------------------------------------
# placing trees
# ---------------------------------------------------------------------------

def distribute(tree, ctx: Ctx, specs=None):
    """`tree` (dicts and tuples of tensors) as DTensors laid out by
    `specs` (default: `param_specs(tree, ctx)`); `tree` itself without a
    mesh."""
    if ctx.mesh is None:
        return tree
    specs = param_specs(tree, ctx) if specs is None else specs

    def rec(t, s):
        if isinstance(t, dict):
            return {k: rec(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return tuple(rec(v, sv) for v, sv in zip(t, s))
        if t is None:
            return None
        return place(t, ctx.mesh, s)

    return rec(tree, specs)


def distribute_batch(batch: dict, ctx: Ctx) -> dict:
    """Every input of a batch with its leading (batch) dim over the data
    axes (`batch_entry`), the rest replicated."""
    if ctx.mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = place(v, ctx.mesh, P(batch_entry(ctx, v.shape[0]),
                                      *[None] * (v.ndim - 1)))
    return out


def distribute_cache(cache, batch: int, ctx: Ctx):
    """A decode cache (a tuple of dicts of tensors) laid out by
    `cache_spec`."""
    if ctx.mesh is None:
        return cache
    return tuple({k: place(v, ctx.mesh, cache_spec(tuple(v.shape), batch,
                                                   ctx))
                  for k, v in c.items()} for c in cache)


def local_call(ctx: Ctx, fn, args, specs, out_spec):
    """`fn(*args)`, over a mesh on each rank's shards of `args` laid out
    by `specs` (`local_map`; the arguments are redistributed to them
    first), its output laid out by `out_spec` (a `P`, or a tuple of them
    for a tuple of outputs).  For a function that is independent along
    every sharded dimension, such as attention over batch rows and
    heads."""
    if ctx.mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = ctx.mesh
    if isinstance(out_spec, P):
        out_pl = list(placements(out_spec, mesh))
    else:
        out_pl = tuple(list(placements(sp, mesh)) for sp in out_spec)
    return local_map(fn, out_placements=out_pl,
                     in_placements=tuple(placements(sp, mesh)
                                         for sp in specs),
                     device_mesh=mesh)(
        *[place(a, mesh, sp) for a, sp in zip(args, specs)])


def gather(x):
    """A DTensor's whole value as one plain tensor; `x` itself otherwise.
    In a local world (`launch.mesh.world`) every rank holds its own
    copy, and they must agree (`reconcile` raises otherwise)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.reconcile() if hasattr(x, "reconcile") else x
