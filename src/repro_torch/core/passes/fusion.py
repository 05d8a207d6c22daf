"""Inter-operator fusion (paper §3.1).

Plan-level canonicalization: adjacent Select nodes are merged into one
conjunction (so downstream passes see a single predicate per pipeline
stage), and Project-over-Project chains are collapsed.

The paper's headline §3.1 rewrite — merging the aggregation's hash map into
the join's hash map so the two materialization points become one — is
realized *structurally* in this engine: the staged whole-query program has
no materialization boundaries at all (every operator is a pure dataflow
region of one XLA program), which is the fixpoint of that optimization.
The contrast configuration (`Settings.fusion = False`) re-introduces the
template-expansion world by placing `optimization_barrier` between operator
regions, preventing XLA from fusing across operator interfaces (paper Fig 2:
"operators are not aware of each other").
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.expr import And


class SelectFusion:
    name = "SelectFusion"

    def run(self, plan: ir.Plan, db, settings) -> ir.Plan:
        return _fuse(plan)


def _fuse(p: ir.Plan) -> ir.Plan:
    kids = [_fuse(c) for c in ir.children(p)]
    ir.replace_children(p, kids)
    if isinstance(p, ir.Select) and isinstance(p.child, ir.Select):
        return _fuse(ir.Select(p.child.child, And(p.child.pred, p.pred)))
    if (isinstance(p, ir.Project) and isinstance(p.child, ir.Project)
            and p.keep_input and p.child.keep_input):
        merged = dict(p.child.outputs)
        merged.update(p.outputs)
        return ir.Project(p.child.child, merged, keep_input=True)
    return p
