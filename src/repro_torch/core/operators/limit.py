"""Limit, with the beyond-paper ORDER BY + LIMIT k -> top-k rewrite.

The global sort over the padded aggregation domain is wasted work when only
k rows survive; with `Settings.topk_limit` the primary sort key feeds a
`torch.topk` selection and only the k survivors are fully sorted.
`Limit.n` must be a static int by the time staging runs (a Param limit is
compile-time and resolved by the ParamBinding pass).
"""
from __future__ import annotations

import torch

from repro_torch.core import ir
from repro_torch.core.expr import Param
from repro_torch.core.operators.base import (Binding, F32BIG, Frame, StageCtx,
                                             frame_nrows)
from repro_torch.core.operators.sort import sort_frame


def stage(lim: ir.Limit, ctx: StageCtx, defer: bool = False) -> Frame:
    if isinstance(lim.n, Param):
        raise TypeError(f"Limit parameter {lim.n.name!r} must be bound at "
                        "compile time (top-k needs a static k)")
    if (ctx.settings.topk_limit and isinstance(lim.child, ir.Sort)
            and lim.child.keys):
        srt = lim.child
        f = ctx.stage(srt.child)
        name0, asc0 = srt.keys[0]
        b0 = f.cols[name0]
        if b0.arr.ndim == 1:
            be = ctx.backend
            k = min(lim.n, frame_nrows(f))
            key = b0.arr.to(torch.float32)
            key = key if not asc0 else -key
            if f.mask is not None:
                key = torch.where(f.mask, key, -F32BIG)
            idx = torch.topk(key, k).indices
            cols = {nm: Binding(be.take(b.arr, idx), b.kind, b.table,
                                b.col) for nm, b in f.cols.items()}
            mask = None if f.mask is None else be.take(f.mask, idx)
            return sort_frame(Frame(cols, mask), srt.keys, ctx)
    f = ctx.stage(lim.child)
    n = min(lim.n, frame_nrows(f))
    cols = {name: Binding(b.arr[:n], b.kind, b.table, b.col)
            for name, b in f.cols.items()}
    mask = None if f.mask is None else f.mask[:n]
    return Frame(cols, mask)
