"""Unused-attribute removal (paper §3.6.1 / struct-field removal §3.7).

Walks the plan top-down computing the set of columns each subtree must
produce and sets `Scan.columns` to exactly that set — pruned columns are
never registered as inputs of the staged program, so they are never loaded
to device (the paper's "avoids loading these unnecessary attributes into
memory").
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.expr import expr_columns
from repro_torch.relational.loader import Database


def output_columns(p: ir.Plan, db: Database) -> set[str]:
    if isinstance(p, ir.Scan):
        cols = db.table(p.table).schema.column_names
        return set(cols if p.columns is None else p.columns)
    if isinstance(p, ir.Select):
        return output_columns(p.child, db)
    if isinstance(p, ir.Project):
        base = output_columns(p.child, db) if p.keep_input else set()
        return base | set(p.outputs)
    if isinstance(p, ir.Join):
        s = output_columns(p.stream, db)
        if p.kind in ("semi", "anti"):
            return s
        return s | output_columns(p.build, db)
    if isinstance(p, ir.Agg):
        return set(p.group_by) | set(p.carry) | {a.name for a in p.aggs}
    if isinstance(p, (ir.Sort, ir.Limit, ir.Compact, ir.Exchange)):
        return output_columns(p.child, db)
    raise TypeError(type(p))


class ColumnPruning:
    name = "ColumnPruning"

    def run(self, plan: ir.Plan, db: Database, settings) -> ir.Plan:
        _prune(plan, output_columns(plan, db), db)
        return plan


def _prune(p: ir.Plan, needed: set[str], db: Database) -> None:
    if isinstance(p, ir.Scan):
        avail = set(db.table(p.table).schema.column_names)
        cols = sorted(needed & avail)
        if p.date_slice is not None and p.date_slice.col in avail:
            # the clustered permutation is the only remnant of the date col
            pass
        p.columns = cols
        return
    if isinstance(p, ir.Select):
        _prune(p.child, needed | expr_columns(p.pred), db)
        return
    if isinstance(p, ir.Project):
        child_needed = set(needed) - set(p.outputs) if not p.keep_input else set(needed) - set(p.outputs)
        for name, e in p.outputs.items():
            if name in needed or not p.keep_input:
                child_needed |= expr_columns(e)
        if p.keep_input:
            child_needed |= needed - set(p.outputs)
        _prune(p.child, child_needed, db)
        return
    if isinstance(p, ir.Join):
        s_avail = output_columns(p.stream, db)
        b_avail = output_columns(p.build, db)
        s_keys = {p.stream_key} | ({p.stream_key2} if p.stream_key2 else set())
        b_keys = {p.build_key} | ({p.build_key2} if p.build_key2 else set())
        _prune(p.stream, (needed & s_avail) | s_keys, db)
        _prune(p.build, ((needed - s_avail) & b_avail) | b_keys, db)
        return
    if isinstance(p, ir.Agg):
        child_needed = set(p.group_by) | set(p.carry)
        for a in p.aggs:
            if a.expr is not None:
                child_needed |= expr_columns(a.expr)
        _prune(p.child, child_needed, db)
        return
    if isinstance(p, ir.Sort):
        _prune(p.child, needed | {k for k, _ in p.keys}, db)
        return
    if isinstance(p, (ir.Limit, ir.Compact, ir.Exchange)):
        # an Exchange gathers whatever its child produces: no new needs
        _prune(p.child, needed, db)
        return
    raise TypeError(type(p))
