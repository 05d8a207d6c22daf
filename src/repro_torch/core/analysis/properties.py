"""Derived static properties per plan node: cardinality upper bounds,
sortedness, date clustering, and positional parent-table alignment.

`analyze(plan, db)` runs one bottom-up dataflow pass and memoizes a
`NodeInfo` per node, so every consumer (the verifier's rules, the
compaction estimator, hash-map lowering) shares a single traversal instead
of re-walking the plan per query.  Plans are mutable, so an `Analysis` is
valid only for the plan shape it was computed against — passes re-run
`analyze` after rewriting (nodes first seen through `info()` after
construction are derived on demand).

Property semantics:

  card        — static upper bound on the node's *valid* output rows: table /
                date-slice sizes at Scans, `Compact` capacities, dense-agg
                domain products, `Limit` cutoffs.  Filters keep the bound
                (a Select can only remove rows).
  sorted_by   — ((col, ascending), ...) ordering the output is known to
                carry: Sort keys, group keys after grouping aggregation,
                the sliced date column after a date slice.
  clustered_by— date column the rows are physically clustered on
                (post-date-slice), the property `date_slice` planning and
                range-residual elision rely on.
  aligned     — parent table T when the node's physical rows are (a masked
                view of) T's rows in order, i.e. row id == T's dense PK.
                This is the soundness condition behind `pk_gather` /
                `bucket_gather` build sides: those strategies address the
                build frame positionally, so anything that re-packs rows
                (a gathering `Compact`, a date slice, a sort) destroys it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import ir
from repro_torch.core.analysis.schema import ColInfo, Schema, node_schema


@dataclasses.dataclass


class NodeInfo:
    schema: Schema
    card: int
    sorted_by: tuple = ()
    clustered_by: Optional[str] = None
    aligned: Optional[str] = None
    # parent table T when the node is a compacted view of T's rows THAT
    # CARRIES the CSR key→slot translation vector (ir.Compact.translate):
    # positional addressing is gone, but a pk_gather probe can recover the
    # compacted slot of any parent row id through slot_of, so the verifier
    # accepts a translated frame where it would demand alignment.  Dropped
    # by anything that loses the staged slot_of (joins, aggs, sorts).
    translated: Optional[str] = None
    # partition root table when the node's frame is partitioned over the
    # mesh's data axis (mirrors the staged Frame.part threading exactly);
    # None = replicated.  `card` is then the PER-SHARD bound — the frame
    # height inside shard_map, which is what Compact capacities and the
    # dense-agg planner must size against.
    part: Optional[str] = None
    # mesh size of the subtree (max over partitioned scans below; 1 when
    # unsharded) — what an Exchange multiplies card by when gathering.
    shards: int = 1


class Analysis:
    """Memoized per-node static properties of one plan against one db."""

    def __init__(self, plan: ir.Plan, db):
        self.plan = plan
        self.db = db
        # keyed by node identity; `_nodes` pins the nodes so a reclaimed
        # id can never alias a stale entry (same hazard PlanCache documents
        # for id(db))
        self._info: dict[int, NodeInfo] = {}
        self._nodes: dict[int, ir.Plan] = {}
        self._visit(plan)

    def info(self, node: ir.Plan) -> NodeInfo:
        got = self._info.get(id(node))
        if got is None:
            got = self._visit(node)
        return got

    def schema(self, node: ir.Plan) -> Schema:
        return self.info(node).schema

    def col(self, node: ir.Plan, name: str) -> Optional[ColInfo]:
        return self.info(node).schema.get(name)

    def _visit(self, p: ir.Plan) -> NodeInfo:
        got = self._info.get(id(p))
        if got is not None:
            return got
        kids = [self._visit(c) for c in ir.children(p)]
        info = _derive(p, self.db, kids)
        self._info[id(p)] = info
        self._nodes[id(p)] = p
        return info


def analyze(plan: ir.Plan, db) -> Analysis:
    """One-pass schema + property inference over `plan` (memoized)."""
    return Analysis(plan, db)


def _keep_order(order: tuple, schema: Schema) -> tuple:
    """Longest sort-key prefix that survives a projection."""
    out = []
    for key in order:
        if key[0] not in schema:
            break
        out.append(key)
    return tuple(out)


def _derive_scan(p: ir.Scan, sch, db, kids) -> NodeInfo:
    t = db.table(p.table)
    n = t.nrows
    if p.shard is not None:
        # partitioned scan: the staged frame is the shard-local block —
        # per-shard card, and positional alignment only for the root
        # (padded position == global row id modulo the pk_gather rebase);
        # a routed child's rows are owner-permuted, alignment is gone.
        aligned = p.table if p.shard.part == p.table else None
        return NodeInfo(sch, p.shard.per_shard_rows, aligned=aligned,
                        part=p.shard.part, shards=p.shard.n_shards)
    if p.date_slice is None:
        return NodeInfo(sch, n, aligned=p.table)
    ds = p.date_slice
    _, start, end = db.date_slice(p.table, ds.col, ds.lo, ds.hi)
    n = max(end - start, 0)
    return NodeInfo(sch, n, sorted_by=((ds.col, True),),
                    clustered_by=ds.col)


def _derive_select(p, sch, db, kids) -> NodeInfo:
    c = kids[0]
    return NodeInfo(sch, c.card, c.sorted_by, c.clustered_by, c.aligned,
                    c.translated, c.part, c.shards)


def _derive_project(p, sch, db, kids) -> NodeInfo:
    c = kids[0]
    clustered = c.clustered_by if c.clustered_by in sch else None
    return NodeInfo(sch, c.card, _keep_order(c.sorted_by, sch),
                    clustered, c.aligned, c.translated, c.part, c.shards)


def _derive_compact(p: ir.Compact, sch, db, kids) -> NodeInfo:
    c = kids[0]
    if p.capacity <= 0:
        # measure-only point: the frame passes through untouched
        return NodeInfo(sch, c.card, c.sorted_by, c.clustered_by, c.aligned,
                        c.translated, c.part, c.shards)
    # a gathering compact keeps relative order but re-packs physical
    # rows, so positional alignment is gone; with `translate` the CSR
    # slot_of vector re-establishes key addressability over what WAS a
    # positionally-aligned frame
    translated = c.aligned if p.translate else None
    return NodeInfo(sch, min(int(p.capacity), c.card), c.sorted_by,
                    c.clustered_by, None, translated, c.part, c.shards)


def _derive_exchange(p: ir.Exchange, sch, db, kids) -> NodeInfo:
    c = kids[0]
    # tiled all-gather: every shard ends up with the full frame — card
    # multiplies by the mesh size and the partition is gone.  Positional
    # alignment survives ONLY for the root's padded row-range layout
    # (position == global row id); a routed child's gathered rows stay
    # owner-permuted.  Per-shard sort order does not concatenate into a
    # global order, so sortedness/clustering are dropped.
    aligned = c.aligned if c.aligned is not None and c.part == c.aligned \
        else None
    return NodeInfo(sch, c.card * max(c.shards, 1), aligned=aligned,
                    shards=c.shards)


def _derive_join(p, sch, db, kids) -> NodeInfo:
    # every strategy emits the stream's physical frame (build columns
    # are gathered into it), so stream properties carry through
    s, b = kids
    return NodeInfo(sch, s.card, s.sorted_by, s.clustered_by, s.aligned,
                    part=s.part, shards=max(s.shards, b.shards))


def _derive_agg(p: ir.Agg, sch, db, kids) -> NodeInfo:
    # every strategy's output is replicated: scalar/dense combine
    # shard-local partials in-operator (psum/pmin/pmax), and generic
    # requires a gathered input (verifier's shard-invariance rule)
    c = kids[0]
    if p.strategy == "scalar" or not p.group_by:
        return NodeInfo(sch, 1, shards=c.shards)
    order = tuple((g, True) for g in p.group_by)
    if p.strategy == "dense":
        card = 1
        for d in p.domains or [c.card]:
            card *= int(d)
        aligned = None
        if len(p.group_by) == 1:
            ci = c.schema.get(p.group_by[0])
            if (ci is not None and ci.parent is not None
                    and p.domains == [db.table(ci.parent).nrows]):
                # dense agg keyed on a full PK domain: output row id
                # IS the key value (Q18's agg-as-build side)
                aligned = ci.parent
        return NodeInfo(sch, card, order, aligned=aligned, shards=c.shards)
    return NodeInfo(sch, c.card, order, shards=c.shards)


def _derive_sort(p: ir.Sort, sch, db, kids) -> NodeInfo:
    c = kids[0]
    return NodeInfo(sch, c.card, tuple(p.keys), part=c.part, shards=c.shards)


def _derive_limit(p: ir.Limit, sch, db, kids) -> NodeInfo:
    c = kids[0]
    n = p.n if isinstance(p.n, int) else c.card
    return NodeInfo(sch, min(int(n), c.card), c.sorted_by, c.clustered_by,
                    part=c.part, shards=c.shards)


# type dispatch, mirroring schema._SCHEMA_FNS: analyze() runs once per
# pass per optimize, so the per-node constant factor matters
_DERIVE_FNS = {
    ir.Scan: _derive_scan,
    ir.Select: _derive_select,
    ir.Project: _derive_project,
    ir.Compact: _derive_compact,
    ir.Exchange: _derive_exchange,
    ir.Join: _derive_join,
    ir.Agg: _derive_agg,
    ir.Sort: _derive_sort,
    ir.Limit: _derive_limit,
}


def _derive(p: ir.Plan, db, kids: list[NodeInfo]) -> NodeInfo:
    fn = _DERIVE_FNS.get(type(p))
    if fn is None:
        raise TypeError(type(p))
    sch = node_schema(p, db, [k.schema for k in kids])
    return fn(p, sch, db, kids)


def composite_pack_bound(
    k1_max: Optional[int], k2_maxes: list[int]
) -> tuple[int, Optional[int]]:
    """(K2, packed_max) for the generic composite-key uint32 pack
    `k1 * K2 + k2`.  K2 must exceed both sides' k2 values or distinct
    pairs collide; `packed_max` (None when k1 is unbounded) must stay
    below 2**32 or the pack wraps and matches garbage.  Shared by the
    staging-time check in `operators/join.py` and the verifier's
    `key-pack` rule, so both report the same bound.
    """
    K2 = int(max(k2_maxes)) + 1 if k2_maxes else 1 << 20
    packed = int(k1_max) * K2 + (K2 - 1) if k1_max is not None else None
    return K2, packed
