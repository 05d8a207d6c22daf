"""The one piece of the Sharding pass that earlier passes consult.

The pass itself (mesh partitioning, Exchange planting) is not ported yet;
`DateIndex` only needs to know which tables a sharded plan would
partition, and the pipeline refuses `Settings.shards != 1` before any
such plan can exist.
"""
from __future__ import annotations

from repro_torch.core.passes.pipeline import Settings


def resolve_shards(settings: Settings) -> int:
    """Concrete shard count: the port runs on one device only."""
    n = int(getattr(settings, "shards", 1) or 0)
    if n != 1:
        raise NotImplementedError(
            "sharded execution (Settings.shards != 1) is not ported to "
            "repro_torch yet")
    return 1


def partitioned_tables(db, settings: Settings) -> set[str]:
    """Tables the Sharding pass would partition (root + FK-routed)."""
    n = resolve_shards(settings)
    if n == 1:
        return set()
    sp = db.shard_plan(n)
    return {t for t in db.tables if sp.part_of(t) is not None}
