"""Date indices (paper §3.2.3), TPU-native form.

The paper clusters rows into year buckets at load time so a date predicate
can skip whole buckets.  With columnar storage we cluster by the *full*
date (load-time sort, `Database.date_cluster`) and lower a date-range
conjunct into a **static row-slice over the clustered permutation**,
resolved host-side at staging time.  The bucket granularity becomes exact,
so the residual per-tuple `if` disappears entirely — a strict improvement
with the same load-time mechanism.

Restriction: a date-sliced scan is re-ordered/subset, which breaks the
parent-row alignment the Partitioning pass needs on the *build* side of an
inner join; the pass therefore only rewrites scans that never serve as an
inner-join build input.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.expr import Cmp, Col, Const, conjoin, conjuncts
from repro_torch.relational.loader import Database
from repro_torch.relational.schema import ColKind


class DateIndex:
    name = "DateIndex"

    def run(self, plan: ir.Plan, db: Database, settings) -> ir.Plan:
        skip = _inner_build_tables(plan)
        if getattr(settings, "shards", 1) != 1:
            # a date-clustered permutation and a range/routed partition
            # cannot compose (the global sort scrambles block ownership):
            # the Sharding pass wins on the tables it will partition.
            from repro_torch.core.passes.sharding import partitioned_tables

            skip = skip | partitioned_tables(db, settings)
        return _rewrite(plan, db, skip)


def _inner_build_tables(plan: ir.Plan) -> set[str]:
    out: set[str] = set()
    for node in ir.walk(plan):
        if isinstance(node, ir.Join) and node.kind in ("inner", "left"):
            for sub in ir.walk(node.build):
                if isinstance(sub, ir.Scan):
                    out.add(sub.table)
    return out


def _rewrite(p: ir.Plan, db: Database, skip: set[str]) -> ir.Plan:
    kids = [_rewrite(c, db, skip) for c in ir.children(p)]
    ir.replace_children(p, kids)

    if not (isinstance(p, ir.Select) and isinstance(p.child, ir.Scan)):
        return p
    scan = p.child
    if scan.table in skip or scan.date_slice is not None:
        return p

    table = db.table(scan.table)
    parts = conjuncts(p.pred)
    # collect per-date-column bounds of the form  Col(date) <op> Const
    bounds: dict[str, dict[str, int]] = {}
    used: dict[str, list] = {}
    for c in parts:
        # A Param bound (rhs not Const) cannot be resolved to a static row
        # slice at staging time: the conjunct is left in the Select and the
        # plan stays param-residual — the predicate evaluates per tuple with
        # the parameter as a runtime scalar input.
        if not (isinstance(c, Cmp) and isinstance(c.lhs, Col)
                and isinstance(c.rhs, Const)):
            continue
        name = c.lhs.name
        if not (table.schema.has_col(name)
                and table.schema.col(name).kind == ColKind.DATE):
            continue
        b = bounds.setdefault(name, {})
        v = int(c.rhs.value)
        if c.op in (">=", ">"):
            b["lo"] = max(b.get("lo", -(1 << 30)), v + (1 if c.op == ">" else 0))
        elif c.op in ("<", "<="):
            b["hi"] = min(b.get("hi", 1 << 30), v + (1 if c.op == "<=" else 0))
        else:
            continue
        used.setdefault(name, []).append(c)

    if not bounds:
        return p
    # choose the most selective date column (estimated from load-time stats)
    best, best_sel = None, 2.0
    for name, b in bounds.items():
        st = table.stats[name]
        span = max(st.max - st.min, 1.0)
        sel = (min(b.get("hi", 1 << 30), st.max + 1)
               - max(b.get("lo", -(1 << 30)), st.min)) / span
        if sel < best_sel:
            best, best_sel = name, sel
    b = bounds[best]
    scan.date_slice = ir.DateSlice(best,
                                   b.get("lo", None),
                                   b.get("hi", None))
    rest = [c for c in parts if c not in used[best]]
    if not rest:
        return scan
    return ir.Select(scan, conjoin(rest))
