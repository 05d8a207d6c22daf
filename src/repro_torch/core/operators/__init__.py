"""The physical-operator layer: one module per operator, each a pure
function `stage(node, ctx, defer=False) -> Frame` over the shared
`StageCtx`.  `repro_torch.core.compile` runs this dispatch twice (CPU
collection walk, staged walk on the query's device) and wraps the result
in a `CompiledQuery`."""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.operators import (agg, compact, exchange, join, limit,
                                        project, scan, select, sort)
from repro_torch.core.operators.base import (Binding, Frame, FrameEnv,
                                             StageCtx, frame_nrows)

_DISPATCH = {
    ir.Scan: scan.stage,
    ir.Select: select.stage,
    ir.Project: project.stage,
    ir.Join: join.stage,
    ir.Agg: agg.stage,
    ir.Compact: compact.stage,
    ir.Exchange: exchange.stage,
    ir.Sort: sort.stage,
    ir.Limit: limit.stage,
}


def stage(node: ir.Plan, ctx: StageCtx, defer: bool = False) -> Frame:
    fn = _DISPATCH.get(type(node))
    if fn is None:
        raise TypeError(type(node))
    return fn(node, ctx, defer)


__all__ = ["Binding", "Frame", "FrameEnv", "StageCtx", "frame_nrows",
           "stage"]
