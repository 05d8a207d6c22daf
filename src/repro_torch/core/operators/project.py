"""Project: computed outputs / renames over the child frame."""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.expr import Col, eval_expr
from repro_torch.core.operators.base import Binding, Frame, StageCtx


def stage(proj: ir.Project, ctx: StageCtx, defer: bool = False) -> Frame:
    f = ctx.stage(proj.child, defer)
    env = ctx.env(f)
    new = dict(f.cols) if proj.keep_input else {}
    for name, e in proj.outputs.items():
        if isinstance(e, Col) and e.name in f.cols:
            new[name] = f.cols[e.name]
        else:
            new[name] = Binding(eval_expr(e, env), "num")
    # a Project is elementwise: the compaction pass sinks Compact points
    # below Projects, so capacity/slot_of must survive the projection
    return Frame(new, f.mask, f.pending, f.capacity, f.slot_of, f.part)
