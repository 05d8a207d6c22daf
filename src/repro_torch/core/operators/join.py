"""Join: the PK/FK equi-join of §3.2.1 as a vectorized gather.

  pk_gather — the 1-D partitioned array is the parent table itself, so a
              foreign key value is the parent's row id.

The other lowered strategies (bucket_gather, exists_flag, generic) are not
ported yet and raise.
"""
from __future__ import annotations

import torch

from repro_torch.core import ir
from repro_torch.core.expr import eval_expr
from repro_torch.core.operators.base import (Binding, Frame, StageCtx,
                                             and_masks, frame_nrows)


def _apply_pending(out: Frame, build: Frame, ctx: StageCtx) -> None:
    if build.pending:
        env = ctx.env(out)
        for pred in build.pending:
            out.mask = and_masks(out.mask, eval_expr(pred, env))


def stage(j: ir.Join, ctx: StageCtx, defer: bool = False) -> Frame:
    if j.strategy != "pk_gather":
        raise NotImplementedError(
            f"{j.strategy} joins are not ported to repro_torch yet")
    be = ctx.backend
    stream = ctx.stage(j.stream)
    build = ctx.stage(j.build, defer=not ctx.settings.hoist)
    if build.slot_of is not None:
        # compacted (translate) build side: the parent-positional
        # addressing pk_gather relies on is gone, so probe the CSR
        # key→slot vector first — slot_of lives on the parent row domain,
        # its values address the compacted frame.  A slot of -1 is a
        # mask-invalid parent row; a slot >= n_b is a row the compaction
        # overflowed past capacity (dropped here, but the point's count
        # already exceeds capacity so the runtime re-executes the
        # uncompacted fallback — never a wrong answer).
        n_b = frame_nrows(build)
        slot = be.take(build.slot_of, stream.cols[j.stream_key].arr)
        idx = slot.clamp(0, n_b - 1)
        bmask_g = (slot >= 0) & (slot < n_b)
        if build.mask is not None:
            bmask_g = bmask_g & be.take(build.mask, idx)
    else:
        idx = stream.cols[j.stream_key].arr
        bmask_g = None
        if build.mask is not None:
            bmask_g = be.take(build.mask, idx)
    cols = dict(stream.cols)
    for name, b in build.cols.items():
        if name in cols:
            continue
        g = be.take(b.arr, idx)
        if j.kind == "left" and bmask_g is not None and g.ndim == 1:
            g = torch.where(bmask_g, g, 0)  # missing match -> default 0
        cols[name] = Binding(g, b.kind, b.table, b.col)
    mask = stream.mask
    if j.kind != "left" and bmask_g is not None:
        mask = and_masks(mask, bmask_g)
    out = Frame(cols, mask)
    _apply_pending(out, build, ctx)
    return out
