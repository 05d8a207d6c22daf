"""Compact: selection-vector compaction to a static capacity bucket.

The mask-carrying execution model pays full-table cost in every operator
downstream of a selective predicate.  `Compact` converts the frame to the
dense representation the paper's §3.2 argues for: the valid rows' ids go
into an index vector of *statically planned* `capacity`, then every column
is gathered down to `capacity` rows.  Downstream operators see an
ordinary, much smaller Frame whose mask marks only the pad slots.

If more rows survive than the planner estimated, the surplus is dropped
from the index vector; the point's TRUE valid count is registered through
`StageCtx.note_compact` and surfaced (keyed by point id) as part of the
staged program's third output, where `CompiledQuery` compares it with the
planned capacity and re-executes the uncompacted fallback on overflow.

On the hand-kernel rung the cumsum → searchsorted sequence is replaced by
the compaction kernel (`repro_torch.kernels.compact`), and when the child
is a Select whose predicate is kernel-safe over an elementwise chain, the
predicate itself is evaluated inside the kernel (`compact_pred`): the
mask is never materialized as a frame column.  `translate` points also
emit the CSR key→slot vector consumed by `pk_gather` (see `ir.Compact`).
"""
from __future__ import annotations

import torch

from repro_torch.core import ir
from repro_torch.core.expr import eval_expr
from repro_torch.core.operators import fused as fu
from repro_torch.core.operators.base import (Binding, Frame, StageCtx,
                                             and_masks, frame_nrows)


def _apply_pred(f: Frame, pred, ctx: StageCtx) -> None:
    """Fall back from in-kernel evaluation: apply the intercepted Select's
    predicate to the already-staged frame the ordinary way."""
    f.mask = and_masks(f.mask, eval_expr(pred, ctx.env(f)))


def stage(c: ir.Compact, ctx: StageCtx, defer: bool = False) -> Frame:
    be = ctx.backend
    use_k = ctx.use_kernels
    # fused interception: on the kernel rung, a Select whose predicate is
    # kernel-safe over a pure elementwise chain is absorbed into the
    # compaction kernel — stage its *child* and keep the predicate.  The
    # structural checks run BEFORE staging so the Select is never staged
    # twice; any post-staging surprise falls back to normal evaluation.
    pred = None
    if (use_k and isinstance(c.child, ir.Select)
            and fu.elementwise_chain(c.child.child)
            and fu.kernel_safe(c.child.pred)):
        pred = c.child.pred
        f = ctx.stage(c.child.child)
        if f.mask is not None or f.pending:
            _apply_pred(f, pred, ctx)
            pred = None
    else:
        f = ctx.stage(c.child)
    n = frame_nrows(f)
    cap = int(c.capacity)
    if cap <= 0:
        # measure-only point (the overflow twin): report the true valid
        # count, touch nothing — no gather, no truncation
        if pred is not None:
            _apply_pred(f, pred, ctx)
        count = torch.tensor(n, dtype=torch.int32) if f.mask is None \
            else f.mask.sum(dtype=torch.int32)
        ctx.note_compact(c.point_id, count)
        return f
    if cap >= n:
        # nothing to win (also: the 8-row collection walk, where the frame
        # is a sample slice — schema and input registration are unaffected)
        if pred is not None:
            _apply_pred(f, pred, ctx)
        return f
    operands = None
    if pred is not None:
        operands = fu.collect_operands(f, [pred], [], ctx)
        if operands is None:           # a referenced column isn't 1-D numeric
            _apply_pred(f, pred, ctx)
            pred = None
    slot = None
    if pred is not None:
        cols_d, scalars, pnames = operands
        res = ctx.kernel("compact_pred_query", cols_d, scalars,
                         fu.TileFn(pred, pnames), cap, translate=c.translate)
        idx, count = res[0], res[1]
        if c.translate:
            slot = res[2]
    else:
        mask = f.mask if f.mask is not None else ctx.ones(n)
        if use_k:
            res = ctx.kernel("compact_query", mask, cap,
                             translate=c.translate)
            idx, count = res[0], res[1]
            if c.translate:
                slot = res[2]
        else:
            idx, count = be.compact(mask, cap)
            if c.translate:
                cs = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
                slot = torch.where(mask, cs - 1, -1).to(torch.int32)
    ctx.note_compact(c.point_id, count)
    cols = {name: Binding(be.take(b.arr, idx), b.kind, b.table, b.col)
            for name, b in f.cols.items()}
    newmask = ctx.arange(cap) < count
    return Frame(cols, newmask, f.pending, capacity=cap, slot_of=slot,
                 part=f.part)
