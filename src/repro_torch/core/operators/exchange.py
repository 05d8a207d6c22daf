"""Exchange: explicit cross-shard data movement (ir.Exchange).

The only planted kind is `gather`: all-gather every column (and the
validity mask) along the data axis so each shard holds the full global
frame — the lowering for consumers that need replicated input (generic
join builds, global sorts, sort-based aggregations, the plan root).

Layout consequences (see loader.ShardPlan): a root-partitioned frame
gathers back into global positional order (pad rows stay masked), so
parent-table alignment survives; a routed frame gathers into owner-grouped
order — a permutation of the table, fine for every consumer that forced
the Exchange (they are all order-insensitive or re-sort).

On the collection walk the backend's collectives are identities, so the
operator is shape-transparent there — it registers no inputs of its own.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.operators.base import (Binding, Frame, StageCtx,
                                             frame_nrows)


def stage(x: ir.Exchange, ctx: StageCtx, defer: bool = False) -> Frame:
    f = ctx.stage(x.child)
    if f.part is None:
        # already replicated: the pass only plants Exchange on partitioned
        # subtrees, but a defensive passthrough keeps hand-built plans valid
        return f
    be = ctx.backend
    mask = f.mask if f.mask is not None else ctx.ones(frame_nrows(f))
    cols = {name: Binding(be.all_gather(b.arr, ctx.axis, tiled=True),
                          b.kind, b.table, b.col)
            for name, b in f.cols.items()}
    gmask = be.all_gather(mask, ctx.axis, tiled=True)
    # capacity/slot_of describe per-shard physical layouts; both are
    # meaningless on the gathered frame
    return Frame(cols, gmask, f.pending)
