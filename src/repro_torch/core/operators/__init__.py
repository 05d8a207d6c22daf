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
from repro_torch.core.spans import span

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
# one span name an operator, not one a plan node (`core/spans.py`)
_SPAN = {t: f"repro.op.{t.__name__}" for t in _DISPATCH}


def stage(node: ir.Plan, ctx: StageCtx, defer: bool = False) -> Frame:
    fn = _DISPATCH.get(type(node))
    if fn is None:
        raise TypeError(type(node))
    name, outer = _SPAN[type(node)], ctx.op_span
    ctx.op_span = name
    try:
        with span(name):
            return fn(node, ctx, defer)
    finally:
        ctx.op_span = outer


__all__ = ["Binding", "Frame", "FrameEnv", "StageCtx", "frame_nrows",
           "stage"]
