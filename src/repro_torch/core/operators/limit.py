"""Limit: the first n rows of its child, which is staged whole.

An ORDER BY + LIMIT k is the full stable sort of `sort_frame` cut to k,
for every key order; the port has no `Settings.topk_limit`.  The
reference's top-k rewrite selects on the first sort key alone and then
sorts the k survivors, which keeps the wrong rows among rows tied on
that key whenever the frame is not already in the order of the other
keys (a descending second key over a dense aggregation's ascending
groups); the port does not copy it.
`Limit.n` must be a static int by the time staging runs (a Param limit is
compile-time and resolved by the ParamBinding pass).
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.expr import Param
from repro_torch.core.operators.base import (Binding, Frame, StageCtx,
                                             frame_nrows)


def stage(lim: ir.Limit, ctx: StageCtx, defer: bool = False) -> Frame:
    if isinstance(lim.n, Param):
        raise TypeError(f"Limit parameter {lim.n.name!r} must be bound at "
                        "compile time (top-k needs a static k)")
    f = ctx.stage(lim.child)
    n = min(lim.n, frame_nrows(f))
    cols = {name: Binding(b.arr[:n], b.kind, b.table, b.col)
            for name, b in f.cols.items()}
    mask = None if f.mask is None else f.mask[:n]
    return Frame(cols, mask, part=f.part)
