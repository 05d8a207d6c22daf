"""Query plan IR (logical nodes progressively annotated into physical form).

Progressive lowering (paper §2.3): the plan starts purely logical
(strategy fields at their 'generic' defaults) and each SC-style pass
annotates/rewrites it — Join.strategy 'generic'→'pk_gather', Agg.strategy
'generic'→'dense'/'scalar', Scan.date_slice set, string predicates rewritten
to code predicates, Scan.columns pruned.  `compile.py` then stages the
lowered plan into a single JAX function; `volcano.py` interprets the
*unlowered* plan operator-at-a-time.

Join orientation convention: `build` is the parent/PK side (the side a
hash table would be built on), `stream` is the probe side.  All TPC-H
equi-joins orient naturally with the FK holder streaming.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.expr import Expr


@dataclasses.dataclass
class DateSlice:
    """Static row-range over a date-clustered permutation (§3.2.3)."""
    col: str
    lo: Optional[int]  # inclusive day, None = open
    hi: Optional[int]  # exclusive day, None = open


@dataclasses.dataclass
class ShardInfo:
    """Physical partitioning annotation (Sharding pass, §3.2.1 made
    physical): the scan's rows live partitioned over the mesh's data axis.

    `part` is the partition-root table — the range-partitioned parent
    whose PK range decides row ownership.  The root itself has
    `part == table` (row-range by dense PK, shard s owns rows
    [s*P, (s+1)*P)); an FK child is hash-routed so every row lands on the
    shard owning its parent (`owner = fk // P`).  Two scans with the same
    `part` are co-partitioned: a pk_gather between them never crosses
    shards.  `per_shard_rows` is the static padded per-shard row count
    (the frame's physical height inside shard_map)."""
    part: str
    n_shards: int
    per_shard_rows: int


@dataclasses.dataclass
class Scan:
    table: str
    # set by ColumnPruning: None = all columns
    columns: Optional[list[str]] = None
    # set by DateIndex: replaces the matching conjuncts of an enclosing Select
    date_slice: Optional[DateSlice] = None
    # set by Sharding: table is partitioned over the data axis
    shard: Optional[ShardInfo] = None


@dataclasses.dataclass
class Select:
    child: "Plan"
    pred: Expr


@dataclasses.dataclass
class Project:
    child: "Plan"
    outputs: dict[str, Expr]  # name -> expr; also acts as rename
    keep_input: bool = True   # keep the child's columns alongside


@dataclasses.dataclass
class Join:
    stream: "Plan"
    build: "Plan"
    stream_key: str
    build_key: str
    kind: str = "inner"          # inner | semi | anti | left
    strategy: str = "generic"    # generic | pk_gather | exists_flag | bucket_gather
    build_table: Optional[str] = None  # parent table when pk_gather
    domain: Optional[int] = None       # key domain when exists_flag
    # composite-key equi joins (paper §3.2.1 composite PKs, e.g. partsupp):
    # second key pair; bucket_gather probes the load-time 2-D partitioned
    # array on the first key and discriminates on the second within buckets.
    stream_key2: Optional[str] = None
    build_key2: Optional[str] = None
    bucket_width: Optional[int] = None


@dataclasses.dataclass
class AggSpec:
    name: str
    fn: str          # sum | count | avg | min | max
    expr: Optional[Expr] = None  # None for count(*)


@dataclasses.dataclass
class Agg:
    child: "Plan"
    group_by: list[str]
    aggs: list[AggSpec]
    # columns functionally dependent on the group key (e.g. Q3's o_orderdate
    # given group key l_orderkey) — carried via a 'max' aggregate.
    carry: list[str] = dataclasses.field(default_factory=list)
    strategy: str = "generic"    # generic | dense | scalar  (HashMapLowering)
    # for dense: mixed-radix index expr metadata filled by the pass
    domains: Optional[list[int]] = None
    # statistics hints for derived group keys (paper §3.5.2: key domains
    # inferred from load-time statistics), e.g. Q13's per-customer count.
    domain_hints: dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Compact:
    """Selection-vector compaction (paper §3.2 data-structure
    specialization, XLA-native form): gather the child's mask-valid rows
    into a dense frame of statically planned `capacity` rows.

    Inserted by the Compaction pass after selective operators and before
    expensive consumers, so downstream sorts/gathers/aggregations run over
    `capacity` rows instead of the child's full cardinality.  JAX's
    static-shape constraint makes `capacity` a compile-time constant
    (a power-of-two bucket over the estimated valid-row count); if more
    rows survive at runtime than the planner estimated, the staged
    program's overflow flag fires and the runtime re-executes the
    uncompacted twin plan (CompiledQuery's fallback) — compaction is a
    performance contract, never a correctness one.

    `point_id` names the *candidate site* this point was planted at: the
    Compaction pass numbers every site it considers (planted or not) in
    walk order, so an id stays stable across re-plans even when planting
    decisions change.  The staged program reports each point's true valid
    count keyed by this id, and `PlanCache`'s feedback store uses the
    same ids to override the static estimates on re-plan.  Hand-planted
    nodes (point_id None) get a stable `h<i>` id: the Compaction pass
    assigns it during its walk (so the adaptive feedback can re-plan
    hand-planted capacities too), or compile time does when the pass is
    off.

    `translate=True` additionally emits the CSR key→slot translation
    vector over the child's row domain (`slot_of[row] = compacted slot,
    -1 when invalid`), carried on the staged Frame.  This is what lets a
    `pk_gather` build side be compacted: the join probes `slot_of` by key
    value first, translating parent-positional addressing into the
    compacted frame (q17-class selective builds).  The Compaction pass
    plants translate points on pk_gather build sides under
    `Settings.use_pallas`; the verifier accepts a translated build where
    it would otherwise require positional alignment.
    """
    child: "Plan"
    capacity: int
    point_id: Optional[str] = None
    translate: bool = False


@dataclasses.dataclass
class Exchange:
    """Explicit cross-shard data movement (planted by the Sharding pass).

    Sits between a partitioned producer and a consumer that needs a
    different physical distribution.  Only planted where co-partitioning
    is violated — generic/bucket_gather join builds, pk_gather builds
    whose probe side is partitioned on a different root, global sorts,
    generic (sort-based) aggregations, and the plan root.  Scalar and
    dense aggregations do NOT get an Exchange: they combine shard-local
    partials in-operator through psum/pmin/pmax.

    kind:
      gather — all-gather the shard blocks along the data axis so every
               shard holds the full (global) frame; padded rows stay
               masked out.  Because the partition is row-range over a
               padded block layout, tiled all-gather reconstitutes global
               positional order, so parent-table alignment properties are
               restored (the verifier's Exchange rule relies on this).

    `key` names the column the downstream consumer keys on (diagnostic —
    a future repartition kind would hash on it)."""
    child: "Plan"
    key: Optional[str] = None
    kind: str = "gather"


@dataclasses.dataclass
class Sort:
    child: "Plan"
    keys: list[tuple[str, bool]]  # (col, ascending)


@dataclasses.dataclass
class Limit:
    child: "Plan"
    # a Param here is a *compile-time* parameter: the top-k rewrite needs a
    # static k, so it must be resolved (passes.param_binding) before staging.
    n: "int | object"


Plan = Scan | Select | Project | Join | Agg | Compact | Exchange | Sort | Limit


def children(p: Plan) -> list[Plan]:
    if isinstance(p, Scan):
        return []
    if isinstance(p, Join):
        return [p.stream, p.build]
    return [p.child]


def replace_children(p: Plan, new: list[Plan]) -> None:
    if isinstance(p, Scan):
        return
    if isinstance(p, Join):
        p.stream, p.build = new
        return
    p.child = new[0]


def walk(p: Plan):
    yield p
    for c in children(p):
        yield from walk(c)


def plan_repr(p: Plan, indent: int = 0) -> str:
    """Readable plan dump including the *physical* annotations the passes
    attach (strategies, date-slice bounds, pruned column lists, planned
    capacities) — what verifier errors and pass debugging quote, so a
    dump must pin down the exact lowering, not just the logical shape."""
    pad = "  " * indent
    if isinstance(p, Scan):
        extra = ""
        if p.date_slice:
            ds = p.date_slice
            extra += f" date_slice[{ds.col}:{ds.lo}..{ds.hi}]"
        if p.columns is not None:
            extra += f" cols={p.columns}"
        if p.shard is not None:
            extra += (f" shard[{p.shard.part}x{p.shard.n_shards}"
                      f"@{p.shard.per_shard_rows}]")
        return f"{pad}Scan({p.table}{extra})"
    if isinstance(p, Select):
        return f"{pad}Select\n{plan_repr(p.child, indent + 1)}"
    if isinstance(p, Project):
        keep = "" if p.keep_input else ", keep_input=False"
        return (f"{pad}Project({list(p.outputs)}{keep})\n"
                f"{plan_repr(p.child, indent + 1)}")
    if isinstance(p, Join):
        keys = f"{p.stream_key}={p.build_key}"
        if p.stream_key2 is not None or p.build_key2 is not None:
            keys += f", {p.stream_key2}={p.build_key2}"
        extra = ""
        if p.build_table is not None:
            extra += f" build_table={p.build_table}"
        if p.domain is not None:
            extra += f" domain={p.domain}"
        if p.bucket_width is not None:
            extra += f" bucket_width={p.bucket_width}"
        return (f"{pad}Join[{p.kind}/{p.strategy}]({keys}){extra}\n"
                f"{plan_repr(p.stream, indent + 1)}\n{plan_repr(p.build, indent + 1)}")
    if isinstance(p, Agg):
        extra = ""
        if p.carry:
            extra += f", carry={p.carry}"
        if p.domains is not None:
            extra += f", domains={p.domains}"
        return (f"{pad}Agg[{p.strategy}](by={p.group_by}, "
                f"aggs={[a.name for a in p.aggs]}{extra})\n"
                f"{plan_repr(p.child, indent + 1)}")
    if isinstance(p, Compact):
        pid = f", point={p.point_id}" if p.point_id is not None else ""
        tr = ", translate" if p.translate else ""
        return (f"{pad}Compact(cap={p.capacity}{pid}{tr})\n"
                f"{plan_repr(p.child, indent + 1)}")
    if isinstance(p, Exchange):
        key = f", key={p.key}" if p.key is not None else ""
        return (f"{pad}Exchange[{p.kind}]({key.lstrip(', ')})\n"
                f"{plan_repr(p.child, indent + 1)}")
    if isinstance(p, Sort):
        return f"{pad}Sort({p.keys})\n{plan_repr(p.child, indent + 1)}"
    if isinstance(p, Limit):
        return f"{pad}Limit({p.n})\n{plan_repr(p.child, indent + 1)}"
    raise TypeError(type(p))
