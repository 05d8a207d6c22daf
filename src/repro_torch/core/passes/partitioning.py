"""Data partitioning (paper §3.2.1), TPU-native form.

On TPU, the paper's "1-D partitioned array accessed through the primary
key" is the dense-PK columnar table itself: a foreign-key value *is* the
row index of the parent, so an equi-join on a PK/FK pair lowers to a
vectorized gather (`Join.strategy = 'pk_gather'`).  The generic hash join
(build + probe of a pointer-chased hash table) disappears exactly as in
Fig 7c→7e, but into gathers instead of linked lists.

Requirements checked here:
  * the build side is *parent-aligned*: its rows are (a masked view of) the
    parent table's rows in order — Scans (without date slicing), Selects,
    Projects, nested pk_gather joins, semi/anti masks, and dense
    aggregations whose single group key spans the parent PK domain (Q18's
    agg-then-join) all preserve alignment;
  * the build key is that table's single-column dense primary key;
  * the stream key provably ranges over the same domain (FK declaration).

Semi/anti joins lower to 'exists_flag': a dense boolean array over the key
domain scattered from the build side and gathered at the stream key — the
paper's partitioned-array membership probe.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import ir
from repro_torch.core.passes.provenance import key_parent_table
from repro_torch.relational.loader import Database


def aligned_table(p: ir.Plan, db: Database) -> Optional[str]:
    if isinstance(p, ir.Scan):
        return p.table if p.date_slice is None else None
    if isinstance(p, (ir.Select, ir.Project)):
        return aligned_table(p.child, db)
    if isinstance(p, ir.Join):
        if p.kind in ("semi", "anti") or p.strategy == "pk_gather":
            return aligned_table(p.stream, db)
        return None
    if isinstance(p, ir.Agg):
        if p.strategy == "dense" and len(p.group_by) == 1:
            parent = key_parent_table(p.child, p.group_by[0], db)
            if parent is not None and p.domains == [db.table(parent).nrows]:
                return parent
        return None
    return None


class Partitioning:
    name = "Partitioning"

    def run(self, plan: ir.Plan, db: Database, settings) -> ir.Plan:
        self._rewrite(plan, db)
        return plan

    def _rewrite(self, p: ir.Plan, db: Database) -> None:
        for c in ir.children(p):
            self._rewrite(c, db)
        if not isinstance(p, ir.Join) or p.strategy != "generic":
            return
        if p.kind in ("inner", "left"):
            t = aligned_table(p.build, db)
            if t is None:
                return
            sch = db.table(t).schema
            if p.stream_key2 is not None:
                # composite PK -> 2-D partitioned array (§3.2.1)
                if sch.primary_key == (p.build_key, p.build_key2):
                    fk = sch.fk_for(p.build_key)
                    parent = key_parent_table(p.stream, p.stream_key, db)
                    if fk is not None and parent == fk.ref_table:
                        p.strategy = "bucket_gather"
                        p.build_table = t
                        _, p.bucket_width = db.fk_bucket(t, p.build_key)
                return
            build_is_pk = (sch.primary_key == (p.build_key,)
                           or _is_dense_group_key(p.build, p.build_key, db, t))
            stream_parent = key_parent_table(p.stream, p.stream_key, db)
            if build_is_pk and stream_parent == t:
                p.strategy = "pk_gather"
                p.build_table = t
                p.domain = db.table(t).nrows
        else:  # semi / anti
            parent = key_parent_table(p.stream, p.stream_key, db)
            build_parent = key_parent_table(p.build, p.build_key, db)
            if parent is not None and build_parent == parent:
                p.strategy = "exists_flag"
                p.domain = db.table(parent).nrows


def _is_dense_group_key(p: ir.Plan, key: str, db: Database, t: str) -> bool:
    """Build side is a dense Agg keyed on `key` spanning table t's PK."""
    if isinstance(p, (ir.Select, ir.Project)):
        return _is_dense_group_key(p.child, key, db, t)
    return (isinstance(p, ir.Agg) and p.strategy == "dense"
            and p.group_by == [key]
            and p.domains == [db.table(t).nrows])
