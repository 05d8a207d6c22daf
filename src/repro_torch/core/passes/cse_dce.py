"""Partial evaluation + simplification (paper §3.6).

Constant folding over every expression in the plan (the SC
``PartiallyEvaluate`` step that runs after each domain-specific pass), and
removal of Selects whose predicate folded to TRUE.  Expression-level CSE is
performed by the staging evaluator (structural memoization in `EvalEnv`);
dead *column* elimination is the ColumnPruning pass.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.expr import Const, fold_constants


def transform_exprs(p: ir.Plan, fn) -> None:
    """Apply `fn` to every expression in the plan, in place."""
    for node in ir.walk(p):
        if isinstance(node, ir.Select):
            node.pred = fn(node.pred)
        elif isinstance(node, ir.Project):
            node.outputs = {k: fn(v) for k, v in node.outputs.items()}
        elif isinstance(node, ir.Agg):
            for spec in node.aggs:
                if spec.expr is not None:
                    spec.expr = fn(spec.expr)


class FoldAndSimplify:
    name = "FoldAndSimplify"

    def run(self, plan: ir.Plan, db, settings) -> ir.Plan:
        transform_exprs(plan, fold_constants)
        return _drop_true_selects(plan)


def _drop_true_selects(p: ir.Plan) -> ir.Plan:
    kids = [_drop_true_selects(c) for c in ir.children(p)]
    ir.replace_children(p, kids)
    if isinstance(p, ir.Select) and isinstance(p.pred, Const) and p.pred.value:
        return p.child
    return p
