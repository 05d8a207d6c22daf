"""Sort: masked lexsort over the frame (invalid rows sort last)."""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.operators.base import (Binding, Frame, StageCtx,
                                             frame_nrows)


def stage(srt: ir.Sort, ctx: StageCtx, defer: bool = False) -> Frame:
    f = ctx.stage(srt.child)
    return sort_frame(f, srt.keys, ctx)


def sort_frame(f: Frame, sort_keys, ctx: StageCtx) -> Frame:
    be = ctx.backend
    n = frame_nrows(f)
    mask = f.mask if f.mask is not None else ctx.ones(n)
    keys = []  # major..minor
    for name, asc in sort_keys:
        b = f.cols[name]
        if b.arr.ndim == 2:
            for k in range(b.arr.shape[1]):
                kk = b.arr[:, k]
                keys.append(kk if asc else (255 - kk))
        else:
            arr = b.arr
            keys.append(arr if asc else -arr)
    order = be.lexsort(list(reversed(keys)) + [~mask])
    cols = {name: Binding(be.take(b.arr, order), b.kind, b.table, b.col)
            for name, b in f.cols.items()}
    return Frame(cols, be.take(mask, order), part=f.part)
