"""Sharding: lower the plan onto a 1-D device mesh (beyond-paper).

The paper's partitioning (§3.2.1) is a *logical* specialization — joins
become gathers because the parent table IS the hash table.  This pass
makes the same idea *physical*: the partition root (and every table
FK-routed to it) is split across the mesh's data axis, and the whole
staged program runs once per shard (`core/mesh.py`), each shard seeing
only its block.

Where co-partitioning holds, nothing moves: a pk_gather between a routed
child and the root probes shard-locally (the FK rebases into the local
block).  Where it is violated, this pass plants an **explicit**
`ir.Exchange` node — never silent resharding:

  * generic / bucket_gather join builds over a partitioned subtree
    (key-order or positional access over the full frame);
  * pk_gather builds that are not co-partitioned with their probe side
    (stream part != build part, or the build is not the partition root);
  * global Sort / Limit and generic (sort-based) Agg inputs;
  * the plan root, when still partitioned at output.

Scalar and dense aggregations get **no** Exchange: their operators
combine shard-local partials in place (psum/pmin/pmax), and exists_flag
builds union their dense flag vectors with a pmax — both strictly
cheaper than materializing the gathered frame.

The verifier (analysis/verify.py) re-derives the same partition
properties and enforces (a) no partitioned frame reaches a
shard-variant operator, (b) every Exchange is load-bearing, and (c) the
per-query Exchange count never exceeds the number of eligible
consumers.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.passes.pipeline import Settings


def partitioned_tables(db, settings: Settings) -> set[str]:
    """Tables the Sharding pass will partition (root + FK-routed).

    Passes that run *earlier* (DateIndex) consult this to keep their
    hands off: a global date-clustering permutation and a row-range /
    routed partition cannot compose — the permutation would scramble
    block ownership.
    """
    n = settings.shards     # resolved by optimize()
    if n == 1:
        return set()
    sp = db.shard_plan(n)
    return {t for t in db.tables if sp.part_of(t) is not None}


class Sharding:
    name = "Sharding"

    def run(self, plan: ir.Plan, db, settings: Settings) -> ir.Plan:
        n = settings.shards     # resolved by optimize()
        if n == 1:
            return plan
        sp = db.shard_plan(n)
        plan, part = self._walk(plan, sp, n)
        if part is not None:
            # partitioned at output (plan root is an eligible consumer):
            # gather so the caller sees the full result on every shard.
            plan = ir.Exchange(plan, key=None, kind="gather")
        return plan

    # The walk mirrors the operators' Frame.part threading exactly:
    # returns (possibly rewritten subtree, partition root or None).
    def _walk(self, p: ir.Plan, sp, n: int):
        if isinstance(p, ir.Scan):
            part = sp.part_of(p.table)
            if part is None or p.date_slice is not None:
                # date-sliced scans read the date-clustered permutation,
                # which DateIndex only builds for unpartitioned tables —
                # partitioned_tables() keeps the two passes disjoint, so
                # this arm only fires for hand-built plans.
                return p, None
            p.shard = ir.ShardInfo(part=part, n_shards=n,
                                   per_shard_rows=sp.rows_per_shard(p.table))
            return p, part

        if isinstance(p, ir.Join):
            p.stream, s_part = self._walk(p.stream, sp, n)
            p.build, b_part = self._walk(p.build, sp, n)
            if p.strategy == "exists_flag":
                # dense membership flags are permutation-safe: the
                # operator pmax-unions shard-local flag vectors in place.
                return p, s_part
            if p.strategy == "pk_gather":
                co = (b_part is not None and s_part == b_part
                      and b_part == p.build_table)
                if b_part is not None and not co:
                    p.build = ir.Exchange(p.build, key=p.build_key)
                return p, s_part
            # generic / bucket_gather need the whole build frame
            # (sort order resp. global positional addressing).
            if b_part is not None:
                p.build = ir.Exchange(p.build, key=p.build_key)
            return p, s_part

        if isinstance(p, ir.Agg):
            p.child, c_part = self._walk(p.child, sp, n)
            if p.strategy in ("scalar", "dense"):
                # shard-local partials + in-operator psum/pmin/pmax
                # combine; output is replicated.
                return p, None
            if c_part is not None:
                key = p.group_by[0] if p.group_by else None
                p.child = ir.Exchange(p.child, key=key)
            return p, None

        if isinstance(p, (ir.Sort, ir.Limit)):
            p.child, c_part = self._walk(p.child, sp, n)
            if isinstance(p, ir.Limit) and isinstance(p.child, ir.Sort):
                return p, None  # the Sort arm below already gathered
            if c_part is not None:
                key = (p.keys[0][0] if isinstance(p, ir.Sort) and p.keys
                       else None)
                p.child = ir.Exchange(p.child, key=key)
            return p, None

        if isinstance(p, ir.Exchange):  # hand-planted
            p.child, _ = self._walk(p.child, sp, n)
            return p, None

        # Select / Project / Compact: partition passes straight through
        p.child, c_part = self._walk(p.child, sp, n)
        return p, c_part
