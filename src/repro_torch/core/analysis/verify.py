"""Inter-pass plan verifier: well-formedness rules over the analysis layer.

The pipeline's safety story (paper §2.2: independent black-box plan→plan
passes) only holds if every pass preserves plan well-formedness — a pass
that emits a dangling column reference, a dtype-mismatched join key, or a
`Compact` under a positional build side otherwise surfaces as a cryptic
XLA staging error or a silently wrong answer.  `verify_plan` checks the
rules below; `passes/pipeline.py` calls it after **each** pass when
`Settings.verify_passes` is on, so a violation is attributed to the pass
that introduced it (pass bisection for free).

Adding a rule: write a generator taking `(plan, db, settings, analysis)`
and yielding `Violation`s, and decorate it with `@rule("name")`.  Rules
must describe *soundness* conditions (what the staged operators require),
not planner policy — a rule that merely mirrors one pass's current
decisions will false-positive the moment another pass makes a different
legal choice.  Rules whose condition only holds for fully lowered plans
(e.g. the uint32 key-pack bound, which Partitioning may obviate by
choosing `bucket_gather`) register with `final_only=True` and run only
after the last pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core import expr as E
from repro_torch.core import ir
from repro_torch.core.analysis.properties import (Analysis, analyze,
                                            composite_pack_bound)
from repro_torch.core.analysis.schema import SchemaError
from repro_torch.relational.schema import ColKind


class PlanInvariantError(Exception):
    """A plan violates an inter-pass invariant.  Carries the rule name,
    the pass the plan came out of, and a `plan_repr` excerpt of the
    offending node."""

    def __init__(
        self,
        rule: str,
        message: str,
        node: Optional[ir.Plan] = None,
        pass_name: Optional[str] = None,
    ):
        self.rule = rule
        self.message = message
        self.node = node
        self.pass_name = pass_name
        where = f"after pass {pass_name!r}" if pass_name else "verify"
        excerpt = ""
        if node is not None:
            lines = ir.plan_repr(node).splitlines()
            if len(lines) > 8:
                lines = lines[:8] + ["  ..."]
            excerpt = "\n" + "\n".join("    " + ln for ln in lines)
        super().__init__(f"[{where}] rule {rule!r}: {message}{excerpt}")


@dataclasses.dataclass(frozen=True)


class Violation:
    rule: str
    message: str
    node: Optional[ir.Plan] = None


@dataclasses.dataclass(frozen=True)


class Rule:
    name: str
    fn: Callable
    final_only: bool
    doc: str


RULES: list[Rule] = []


def rule(name: str, final_only: bool = False):
    """Register a verifier rule: a generator of `Violation`s."""

    def deco(fn):
        RULES.append(Rule(name, fn, final_only, (fn.__doc__ or "").strip()))
        return fn

    return deco


def check_plan(
    plan: ir.Plan, db, settings=None, final: bool = True
) -> list[Violation]:
    """All violations in `plan` (empty list = well-formed).  Schema
    inference failures short-circuit: the rules need schemas to run."""
    try:
        a = analyze(plan, db)
    except SchemaError as err:
        return [Violation("schema", str(err), err.node)]
    out: list[Violation] = []
    for r in RULES:
        if r.final_only and not final:
            continue
        out.extend(r.fn(plan, db, settings, a))
    return out


def verify_plan(plan: ir.Plan, db, settings=None,
                pass_name: Optional[str] = None, final: bool = True) -> None:
    """Raise `PlanInvariantError` (attributed to `pass_name`) on the first
    violation found in `plan`."""
    violations = check_plan(plan, db, settings, final)
    if violations:
        v = violations[0]
        raise PlanInvariantError(v.rule, v.message, v.node, pass_name)


# ---------------------------------------------------------------------------
# rule helpers
# ---------------------------------------------------------------------------


def _node_exprs(node: ir.Plan):
    """Expression positions of a node, evaluated against its child schema."""
    if isinstance(node, ir.Select):
        yield node.pred
    elif isinstance(node, ir.Project):
        yield from node.outputs.values()
    elif isinstance(node, ir.Agg):
        for spec in node.aggs:
            if spec.expr is not None:
                yield spec.expr


_POSITIONAL = ("pk_gather", "bucket_gather")
_KEYABLE = {"int", "code", "date", "bool"}


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@rule("column-resolution")


def _columns_resolve(plan, db, settings, a: Analysis):
    """Every Col / join key / sort key resolves in the child schema.
    (Scan columns, Project renames and Agg group/carry keys are already
    enforced during schema inference.)"""
    for node in ir.walk(plan):
        if isinstance(node, ir.Join):
            s, b = a.schema(node.stream), a.schema(node.build)
            pairs = [
                (node.stream_key, s, "stream"),
                (node.build_key, b, "build"),
                (node.stream_key2, s, "stream"),
                (node.build_key2, b, "build"),
            ]
            for key, sch, side in pairs:
                if key is not None and key not in sch:
                    yield Violation(
                        "column-resolution",
                        f"join {side} key {key!r} is not produced by the "
                        f"{side} side", node)
            continue
        kids = ir.children(node)
        child = a.schema(kids[0]) if kids else {}
        for e in _node_exprs(node):
            for name in E.expr_columns(e):
                if name not in child:
                    yield Violation(
                        "column-resolution",
                        f"column {name!r} referenced by "
                        f"{type(node).__name__} is not produced by its "
                        "input", node)
        if isinstance(node, ir.Sort):
            for name, _asc in node.keys:
                if name not in child:
                    yield Violation(
                        "column-resolution",
                        f"sort key {name!r} is not produced by the input",
                        node)


@rule("expr-dtypes")


def _expr_dtypes(plan, db, settings, a: Analysis):
    """String-family columns only appear under string operators: a TEXT
    column in arithmetic/comparison position, a code predicate on a
    non-CAT column, or a word predicate on a non-TEXT column is a
    miscompile in waiting."""
    code_ops = (E.StrEq, E.StrIn, E.StrStartsWith, E.CodeEq, E.CodeIn,
                E.CodeRange)
    word_ops = (E.StrContainsWord, E.WordCode)

    def walk_expr(e, schema, node):
        if isinstance(e, E.Col):
            ci = schema.get(e.name)
            if ci is not None and ci.dtype == "string":
                yield Violation(
                    "expr-dtypes",
                    f"TEXT column {e.name!r} used in scalar expression "
                    "position", node)
            return
        if isinstance(e, code_ops):
            ci = schema.get(e.col)
            if ci is not None and ci.dtype != "code":
                yield Violation(
                    "expr-dtypes",
                    f"string predicate {type(e).__name__} on non-CAT "
                    f"column {e.col!r} ({ci.dtype})", node)
            return
        if isinstance(e, word_ops):
            ci = schema.get(e.col)
            if ci is not None and ci.dtype != "string":
                yield Violation(
                    "expr-dtypes",
                    f"word predicate {type(e).__name__} on non-TEXT "
                    f"column {e.col!r} ({ci.dtype})", node)
            return
        if isinstance(e, (E.Arith, E.Cmp, E.And, E.Or)):
            yield from walk_expr(e.lhs, schema, node)
            yield from walk_expr(e.rhs, schema, node)
        elif isinstance(e, (E.Not, E.Year)):
            yield from walk_expr(e.operand, schema, node)
        elif isinstance(e, E.Where):
            yield from walk_expr(e.cond, schema, node)
            yield from walk_expr(e.then, schema, node)
            yield from walk_expr(e.other, schema, node)

    for node in ir.walk(plan):
        kids = ir.children(node)
        if not kids:
            continue
        child = a.schema(kids[0])
        for e in _node_exprs(node):
            if isinstance(node, ir.Project) and isinstance(e, E.Col):
                continue  # a bare rename may carry any dtype, TEXT included
            yield from walk_expr(e, child, node)


@rule("join-keys")


def _join_keys(plan, db, settings, a: Analysis):
    """Join key pairs carry the same integer-class dtype family (float
    keys don't equi-join exactly; string keys never lower)."""
    for node in ir.walk(plan):
        if not isinstance(node, ir.Join):
            continue
        pairs = [(node.stream_key, node.build_key)]
        if node.stream_key2 is not None or node.build_key2 is not None:
            pairs.append((node.stream_key2, node.build_key2))
        for skey, bkey in pairs:
            if skey is None or bkey is None:
                yield Violation(
                    "join-keys",
                    "composite join carries only one side's second key",
                    node)
                continue
            sci = a.col(node.stream, skey)
            bci = a.col(node.build, bkey)
            if sci is None or bci is None:
                continue  # column-resolution reports the dangling key
            if sci.dtype != bci.dtype:
                yield Violation(
                    "join-keys",
                    f"key dtype mismatch: {skey!r} is {sci.dtype}, "
                    f"{bkey!r} is {bci.dtype}", node)
            elif sci.dtype not in _KEYABLE:
                yield Violation(
                    "join-keys",
                    f"join on non-integer key {skey!r} ({sci.dtype})", node)
        if node.strategy == "exists_flag" and node.domain is not None:
            sci = a.col(node.stream, node.stream_key)
            if (sci is not None and sci.domain is not None
                    and sci.domain > node.domain):
                yield Violation(
                    "join-keys",
                    f"exists_flag domain {node.domain} is smaller than the "
                    f"stream key domain {sci.domain} — probes past the "
                    "flag array", node)


@rule("positional-build-alignment")


def _build_alignment(plan, db, settings, a: Analysis):
    """`pk_gather`/`bucket_gather` address the build frame positionally
    (a key value is a row id), so the build subtree must stay aligned to
    the parent table: no gathering Compact, date slice, or sort below it,
    and the stream key must range over exactly that table's PK domain."""
    for node in ir.walk(plan):
        if not isinstance(node, ir.Join) or node.strategy not in _POSITIONAL:
            continue
        if node.build_table is None:
            yield Violation(
                "positional-build-alignment",
                f"{node.strategy} join without build_table", node)
            continue
        info = a.info(node.build)
        got = info.aligned
        # a pk_gather build may instead be a *translated* compact of the
        # parent (ir.Compact.translate): the CSR slot_of vector recovers
        # the compacted slot of any parent row id, so key addressing
        # survives re-packing.  bucket_gather probes a 2-D bucket matrix
        # whose entries are parent row ids — translation does not apply.
        translated_ok = (node.strategy == "pk_gather"
                         and info.translated == node.build_table)
        if got != node.build_table and not translated_ok:
            yield Violation(
                "positional-build-alignment",
                f"build side is not aligned to {node.build_table!r} "
                f"(aligned={got!r}) — a Compact/date-slice/sort below a "
                "positional build destroys row addressing", node)
        if node.strategy == "pk_gather":
            sci = a.col(node.stream, node.stream_key)
            if sci is not None and sci.parent != node.build_table:
                yield Violation(
                    "positional-build-alignment",
                    f"stream key {node.stream_key!r} does not range over "
                    f"{node.build_table!r}'s primary key "
                    f"(parent={sci.parent!r})", node)


@rule("dense-agg-domain")


def _dense_domains(plan, db, settings, a: Analysis):
    """`dense` aggregation scatters into a statically allocated array, so
    every group key needs a static domain bound covered by the planned
    `domains` (and `scalar` means *no* group keys at all)."""
    for node in ir.walk(plan):
        if not isinstance(node, ir.Agg):
            continue
        if node.strategy == "scalar" and node.group_by:
            yield Violation(
                "dense-agg-domain",
                "scalar Agg with group keys drops the grouping", node)
        if node.strategy != "dense":
            continue
        if not node.domains or len(node.domains) != len(node.group_by):
            yield Violation(
                "dense-agg-domain",
                f"dense Agg needs one domain per group key, got "
                f"domains={node.domains} for keys {node.group_by}", node)
            continue
        if settings is not None:
            total = 1
            for d in node.domains:
                total *= int(d)
            if total > settings.dense_agg_cap:
                yield Violation(
                    "dense-agg-domain",
                    f"dense domain product {total} exceeds dense_agg_cap "
                    f"{settings.dense_agg_cap}", node)
        child = a.schema(node.child)
        for g, d in zip(node.group_by, node.domains):
            bound = node.domain_hints.get(g)
            if bound is None:
                ci = child.get(g)
                bound = ci.domain if ci is not None else None
            if bound is None:
                yield Violation(
                    "dense-agg-domain",
                    f"dense Agg key {g!r} has no statically bounded "
                    "domain", node)
            elif int(d) < int(bound):
                yield Violation(
                    "dense-agg-domain",
                    f"planned domain {d} for key {g!r} is below its "
                    f"static bound {bound} — keys would scatter out of "
                    "range", node)


@rule("date-slice")


def _date_slice(plan, db, settings, a: Analysis):
    """`date_slice` only on DATE columns of the scanned table, with a
    sane [lo, hi) window."""
    for node in ir.walk(plan):
        if not isinstance(node, ir.Scan) or node.date_slice is None:
            continue
        ds = node.date_slice
        sch = db.table(node.table).schema
        if not sch.has_col(ds.col):
            yield Violation(
                "date-slice",
                f"date_slice on unknown column {node.table}.{ds.col}", node)
        elif sch.col(ds.col).kind != ColKind.DATE:
            yield Violation(
                "date-slice",
                f"date_slice on non-DATE column {node.table}.{ds.col} "
                f"({sch.col(ds.col).kind.value})", node)
        if ds.lo is not None and ds.hi is not None and ds.lo > ds.hi:
            yield Violation(
                "date-slice",
                f"empty date_slice window lo={ds.lo} > hi={ds.hi}", node)


@rule("limit-above-sort")


def _limit_above_sort(plan, db, settings, a: Analysis):
    """`Limit` only directly above `Sort` (or another Limit): the staged
    operator takes the first n *physical* rows, which is only meaningful
    once a sort has packed valid rows to the front in order."""
    for node in ir.walk(plan):
        if isinstance(node, ir.Limit) and not isinstance(
                node.child, (ir.Sort, ir.Limit)):
            yield Violation(
                "limit-above-sort",
                f"Limit over {type(node.child).__name__} — the cutoff "
                "needs sorted, front-packed input", node)


@rule("compact-capacity")


def _compact_capacity(plan, db, settings, a: Analysis):
    """Compact capacities are non-negative static shapes (0 = measure-only
    point)."""
    for node in ir.walk(plan):
        if isinstance(node, ir.Compact) and int(node.capacity) < 0:
            yield Violation(
                "compact-capacity",
                f"negative Compact capacity {node.capacity}", node)


@rule("param-dtypes")


def _param_dtypes(plan, db, settings, a: Analysis):
    """Param dtypes are consistent plan-wide and agree with
    `param_binding`'s runtime/compile-time classification: string params
    (and `Limit.n`) must be substituted before staging, numeric params
    must not appear where a string is expected."""
    from repro_torch.core.passes.param_binding import plan_params

    try:
        plan_params(plan)
    except TypeError as err:
        yield Violation("param-dtypes", str(err), plan)
        return

    def numeric_params(e):
        # Params reachable in *scalar expression* position; the structural
        # positions (Str* values, Limit.n) are handled separately
        if isinstance(e, E.Param):
            yield e
        elif isinstance(e, (E.Arith, E.Cmp, E.And, E.Or)):
            yield from numeric_params(e.lhs)
            yield from numeric_params(e.rhs)
        elif isinstance(e, (E.Not, E.Year)):
            yield from numeric_params(e.operand)
        elif isinstance(e, E.Where):
            yield from numeric_params(e.cond)
            yield from numeric_params(e.then)
            yield from numeric_params(e.other)

    for node in ir.walk(plan):
        for e in _node_exprs(node):
            for param in numeric_params(e):
                if param.dtype == "str":
                    yield Violation(
                        "param-dtypes",
                        f"string parameter {param.name!r} in scalar "
                        "expression position", node)
        if isinstance(node, ir.Limit) and isinstance(node.n, E.Param):
            if not node.n.dtype.startswith("int"):
                yield Violation(
                    "param-dtypes",
                    f"Limit.n parameter {node.n.name!r} must be integer, "
                    f"got dtype {node.n.dtype!r}", node)


def _strip_transparent(node: ir.Plan) -> ir.Plan:
    """Descend through frame-transparent wrappers (Compact re-packs rows,
    Project adds columns — neither changes the partition state), so the
    Exchange rules see the node a consumer physically reads."""
    while isinstance(node, (ir.Compact, ir.Project)):
        node = node.child
    return node


def _co_partitioned(j: ir.Join, build_info, stream_info) -> bool:
    """pk_gather crosses no shard boundary iff the probe side is
    partitioned on the build table's own range partition."""
    return (build_info.part is not None
            and stream_info.part == build_info.part
            and build_info.part == j.build_table)


@rule("shard-invariance")


def _shard_invariance(plan, db, settings, a: Analysis):
    """No partitioned frame reaches an operator whose lowering would see
    only a shard-local slice: global Sort/Limit, generic (sort-based)
    aggregation, generic/bucket_gather join builds, pk_gather builds not
    co-partitioned with their probe side, and the plan output itself.
    The Sharding pass plants a gather Exchange at each of these sites —
    this rule turns a missing one into a verify failure instead of a
    silently partial answer.  exists_flag builds and scalar/dense Agg
    inputs may stay partitioned: their operators combine shard-local
    partials in place (pmax flag union resp. psum/pmin/pmax)."""
    for node in ir.walk(plan):
        if isinstance(node, (ir.Sort, ir.Limit)):
            ci = a.info(node.child)
            if ci.part is not None:
                yield Violation(
                    "shard-invariance",
                    f"{type(node).__name__} over a frame partitioned on "
                    f"{ci.part!r} — a per-shard order is not a global "
                    "order", node)
        elif isinstance(node, ir.Agg):
            if node.strategy in ("scalar", "dense") or not node.group_by:
                continue
            ci = a.info(node.child)
            if ci.part is not None:
                yield Violation(
                    "shard-invariance",
                    "generic (sort-based) Agg over a frame partitioned on "
                    f"{ci.part!r} — shard-local groups would not merge",
                    node)
        elif isinstance(node, ir.Join):
            bi = a.info(node.build)
            if bi.part is None or node.strategy == "exists_flag":
                continue
            if node.strategy == "pk_gather":
                if not _co_partitioned(node, bi, a.info(node.stream)):
                    yield Violation(
                        "shard-invariance",
                        f"pk_gather build partitioned on {bi.part!r} is "
                        "not co-partitioned with its probe side "
                        f"(stream part={a.info(node.stream).part!r}, "
                        f"build_table={node.build_table!r})", node)
            else:
                yield Violation(
                    "shard-invariance",
                    f"{node.strategy} join build partitioned on "
                    f"{bi.part!r} — the strategy reads the whole build "
                    "frame", node)
    if a.info(plan).part is not None:
        yield Violation(
            "shard-invariance",
            f"plan output is partitioned on {a.info(plan).part!r} — the "
            "caller sees one shard's block", plan)


@rule("exchange-placement")


def _exchange_placement(plan, db, settings, a: Analysis):
    """Every Exchange is load-bearing: a known kind, a partitioned child,
    and a position directly below an eligible consumer (join build,
    Sort/Limit, generic Agg, or the plan root — modulo frame-transparent
    Compact/Project wrappers).  A co-partitioned pk_gather build must NOT
    be gathered: the gather would materialize the full parent on every
    shard and defeat the partitioning it verifies against."""
    parents: dict[int, ir.Plan] = {}
    for node in ir.walk(plan):
        for c in ir.children(node):
            parents[id(c)] = node
    for node in ir.walk(plan):
        if isinstance(node, ir.Join) and node.strategy == "pk_gather":
            below = _strip_transparent(node.build)
            if isinstance(below, ir.Exchange):
                if _co_partitioned(node, a.info(below.child),
                                   a.info(node.stream)):
                    yield Violation(
                        "exchange-placement",
                        "gather Exchange on a co-partitioned pk_gather "
                        "build — the probe is already shard-local", node)
        if not isinstance(node, ir.Exchange):
            continue
        if node.kind != "gather":
            yield Violation(
                "exchange-placement",
                f"unknown Exchange kind {node.kind!r}", node)
        if a.info(node.child).part is None:
            yield Violation(
                "exchange-placement",
                "Exchange over a replicated frame — nothing to gather",
                node)
        cur, par = node, parents.get(id(node))
        while par is not None and isinstance(par, (ir.Compact, ir.Project)):
            cur, par = par, parents.get(id(par))
        ok = (par is None
              or isinstance(par, (ir.Sort, ir.Limit))
              or (isinstance(par, ir.Join) and par.build is cur
                  and par.strategy != "exists_flag")
              or (isinstance(par, ir.Agg)
                  and par.strategy not in ("scalar", "dense")
                  and bool(par.group_by)))
        if not ok:
            yield Violation(
                "exchange-placement",
                f"Exchange below {type(par).__name__} — not an eligible "
                "consumer (join build, Sort/Limit, generic Agg, or plan "
                "root)", node)


@rule("exchange-count", final_only=True)


def _exchange_count(plan, db, settings, a: Analysis):
    """Per-query Exchange budget: at most one per co-partitioning
    violation — non-co-partitioned join builds, global Sort/Limit and
    generic Agg inputs that are partitioned, and a partitioned plan
    output.  With exchange-placement pinning each Exchange directly
    below such a site, a pass that starts spraying gathers fails
    verification instead of silently serializing the query."""
    n_exchange = sum(isinstance(n, ir.Exchange) for n in ir.walk(plan))
    if n_exchange == 0:
        return
    sites = 0
    for node in ir.walk(plan):
        if isinstance(node, ir.Join):
            if node.strategy == "exists_flag":
                continue
            below = _strip_transparent(node.build)
            inner = below.child if isinstance(below, ir.Exchange) else below
            ii = a.info(inner)
            if ii.part is None:
                continue
            if node.strategy == "pk_gather" and _co_partitioned(
                    node, ii, a.info(node.stream)):
                continue
            sites += 1
        elif isinstance(node, (ir.Sort, ir.Limit)) or (
                isinstance(node, ir.Agg)
                and node.strategy not in ("scalar", "dense")
                and node.group_by):
            below = _strip_transparent(node.child)
            inner = below.child if isinstance(below, ir.Exchange) else below
            if a.info(inner).part is not None:
                sites += 1
    top = _strip_transparent(plan)
    top_in = top.child if isinstance(top, ir.Exchange) else top
    if a.info(top_in).part is not None:
        sites += 1
    if n_exchange > sites:
        yield Violation(
            "exchange-count",
            f"{n_exchange} Exchange nodes for {sites} co-partitioning "
            "violations — at least one gather is gratuitous", plan)


@rule("key-pack", final_only=True)


def _key_pack(plan, db, settings, a: Analysis):
    """A fully lowered generic composite join packs `k1 * K2 + k2` into
    uint32; the bound derived from load-time stats must fit or the pack
    wraps and matches garbage.  Final-only: Partitioning may still lower
    the join to `bucket_gather`, which never packs."""
    for node in ir.walk(plan):
        if (not isinstance(node, ir.Join) or node.strategy != "generic"
                or node.stream_key2 is None or node.build_key2 is None):
            continue
        sci = a.col(node.stream, node.stream_key)
        bci = a.col(node.build, node.build_key)
        s2 = a.col(node.stream, node.stream_key2)
        b2 = a.col(node.build, node.build_key2)
        k2_maxes = [int(ci.hi) for ci in (s2, b2)
                    if ci is not None and ci.hi is not None]
        k1_maxes = [int(ci.hi) for ci in (sci, bci)
                    if ci is not None and ci.hi is not None]
        k1_max = max(k1_maxes) if k1_maxes else None
        K2, packed = composite_pack_bound(k1_max, k2_maxes)
        if packed is not None and packed >= 2**32:
            yield Violation(
                "key-pack",
                f"composite join key ({node.stream_key},"
                f"{node.stream_key2}) cannot pack into uint32: "
                f"max_k1={k1_max} * K2={K2} + {K2 - 1} = {packed} "
                ">= 2**32", node)
