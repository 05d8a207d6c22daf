"""Select: predicate evaluation into the frame's validity mask.

With `defer=True` (domain-specific code motion, §3.5) the predicate is
queued on the frame and evaluated by the consuming join *after* the gather,
hoisting the evaluation off the build side's full cardinality.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.expr import eval_expr
from repro_torch.core.operators.base import Frame, StageCtx, and_masks


def stage(sel: ir.Select, ctx: StageCtx, defer: bool = False) -> Frame:
    f = ctx.stage(sel.child, defer)
    if defer:
        f.pending.append(sel.pred)
        return f
    f.mask = and_masks(f.mask, eval_expr(sel.pred, ctx.env(f)))
    return f
