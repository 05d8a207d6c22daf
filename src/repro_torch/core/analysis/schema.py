"""Bottom-up schema and provenance inference over the plan IR.

The paper's specialization passes all rest on *schema + statistics
knowledge*: which base column a plan column descends from, what its dtype
family is, and how large its value domain can get.  Before this module each
pass re-derived that knowledge with its own recursive plan walk
(`passes/provenance.py`, `compaction._base_column`, join's `_stats_max`);
here it is computed once, bottom-up, as a `{name: ColInfo}` schema per plan
node, and the passes (plus the inter-pass verifier in `analysis/verify.py`)
consume the shared result.

Dtype families (`ColInfo.dtype`) collapse the physical kinds of
`relational/schema.py` into what plan-level reasoning needs:

  'int'    — int32 scalars (keys, quantities, counts, Year() results)
  'float'  — float32 scalars
  'date'   — int32 days-since-epoch
  'code'   — CAT dictionary codes (int32 at runtime, but joining or
             arithmetic against plain ints is almost always a plan bug)
  'string' — TEXT word matrices (never scalar-comparable)
  'bool'   — predicate results materialized through Project outputs

Inference failures (a dangling `Col`, a `Scan` naming an unknown column)
raise `SchemaError`; the verifier converts that into a
`PlanInvariantError` attributed to the pass that produced the plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import expr as E
from repro_torch.core import ir
from repro_torch.relational.schema import ColKind

_KIND_DTYPE = {
    ColKind.INT: "int",
    ColKind.FLOAT: "float",
    ColKind.DATE: "date",
    ColKind.CAT: "code",
    ColKind.TEXT: "string",
}

# integer stats-derived domains beyond this are treated as unbounded
# (mirrors the historical provenance.col_domain cutoff)
_DOMAIN_CUTOFF = 1 << 20


class SchemaError(Exception):
    """A plan node references a column its input does not produce."""

    def __init__(self, node: Optional[ir.Plan], message: str):
        super().__init__(message)
        self.node = node


@dataclasses.dataclass(frozen=True)


class ColInfo:
    """Static knowledge about one output column of a plan node.

    `table`/`col` name the base column this one descends from (None for
    computed expressions — they have a dtype but no provenance).  `parent`
    is the table whose dense primary key this column's values index (its
    own table for a PK, the referenced table for a FK) — the fact the
    partitioning pass keys on.  `domain` is a static exclusive upper bound
    on non-negative values (vocabulary size for CAT, parent row count for
    key columns, stats-derived for small ints); `lo`/`hi` are the
    load-time min/max stats where available.
    """

    dtype: str
    table: Optional[str] = None
    col: Optional[str] = None
    parent: Optional[str] = None
    domain: Optional[int] = None
    lo: Optional[float] = None
    hi: Optional[float] = None


Schema = dict[str, ColInfo]

# expression nodes that consume string/code columns by name
_STRING_EXPRS = (
    E.StrEq,
    E.StrIn,
    E.StrStartsWith,
    E.StrContainsWord,
    E.CodeEq,
    E.CodeIn,
    E.CodeRange,
    E.WordCode,
)


def expr_dtype(e: E.Expr, schema: Schema, node: Optional[ir.Plan] = None) -> str:
    """Dtype family of an expression over `schema` (raises SchemaError on a
    dangling Col so Project/Agg inference surfaces bad references)."""
    if isinstance(e, E.Col):
        ci = schema.get(e.name)
        if ci is None:
            raise SchemaError(
                node, f"column {e.name!r} is not produced by the input")
        return ci.dtype
    if isinstance(e, E.Const):
        if isinstance(e.value, bool):
            return "bool"
        return "int" if isinstance(e.value, int) else "float"
    if isinstance(e, E.Param):
        if e.dtype == "str":
            return "string"
        if e.dtype == "bool":
            return "bool"
        return "int" if e.dtype.startswith("int") else "float"
    if isinstance(e, E.Arith):
        a = expr_dtype(e.lhs, schema, node)
        b = expr_dtype(e.rhs, schema, node)
        if e.op == "/" or "float" in (a, b):
            return "float"
        return "int"
    if isinstance(e, E.Where):
        expr_dtype(e.cond, schema, node)
        a = expr_dtype(e.then, schema, node)
        b = expr_dtype(e.other, schema, node)
        if a == b:
            return a
        return "float" if "float" in (a, b) else a
    if isinstance(e, E.Year):
        expr_dtype(e.operand, schema, node)
        return "int"
    if isinstance(e, (E.Cmp, E.And, E.Or, E.Not)):
        for sub in _expr_operands(e):
            expr_dtype(sub, schema, node)
        return "bool"
    if isinstance(e, _STRING_EXPRS):
        if e.col not in schema:
            raise SchemaError(node, f"column {e.col!r} is not produced by the input")
        return "bool"
    raise SchemaError(node, f"unknown expression node {type(e).__name__}")


def _expr_operands(e: E.Expr):
    if isinstance(e, (E.Arith, E.Cmp, E.And, E.Or)):
        return (e.lhs, e.rhs)
    if isinstance(e, (E.Not, E.Year)):
        return (e.operand,)
    if isinstance(e, E.Where):
        return (e.cond, e.then, e.other)
    return ()


def base_colinfo(table_name: str, name: str, db) -> ColInfo:
    """ColInfo of a base table column, from schema declarations + stats.

    Cached on the Table (analysis re-derives base schemas on every
    optimize); the stats signature revalidates each hit because tests and
    reload paths mutate `Table.stats` in place."""
    t = db.table(table_name)
    st = t.stats.get(name)
    sig = (st.min, st.max, st.n_distinct) if st is not None else None
    hit = t._colinfo_cache.get(name)
    if hit is not None and hit[0] == sig:
        return hit[1]
    sch = t.schema
    cdef = sch.col(name)
    dtype = _KIND_DTYPE[cdef.kind]
    parent: Optional[str] = None
    if sch.primary_key == (name,):
        parent = table_name
    else:
        fk = sch.fk_for(name)
        if fk is not None:
            parent = fk.ref_table
    lo = hi = None
    if st is not None and cdef.kind in (ColKind.INT, ColKind.FLOAT,
                                        ColKind.DATE, ColKind.CAT):
        lo, hi = float(st.min), float(st.max)
    domain: Optional[int] = None
    if cdef.kind == ColKind.CAT:
        domain = len(t.vocabs[name])
    elif cdef.kind == ColKind.INT:
        if parent is not None:
            domain = db.table(parent).nrows
        elif st is not None and st.min >= 0 and st.max < _DOMAIN_CUTOFF:
            domain = int(st.max) + 1
    ci = ColInfo(dtype, table_name, name, parent, domain, lo, hi)
    t._colinfo_cache[name] = (sig, ci)
    return ci


def _scan_schema(p: ir.Scan, db, kids: list[Schema]) -> Schema:
    sch = db.table(p.table).schema
    names = p.columns if p.columns is not None else sch.column_names
    out: Schema = {}
    for name in names:
        if not sch.has_col(name):
            raise SchemaError(
                p, f"scan of {p.table!r} names unknown column {name!r}")
        out[name] = base_colinfo(p.table, name, db)
    return out


def _passthrough_schema(p, db, kids: list[Schema]) -> Schema:
    return kids[0]


def _project_schema(p: ir.Project, db, kids: list[Schema]) -> Schema:
    child = kids[0]
    out = dict(child) if p.keep_input else {}
    for name, e in p.outputs.items():
        if isinstance(e, E.Col):
            ci = child.get(e.name)
            if ci is None:
                raise SchemaError(
                    p,
                    f"project output {name!r} renames {e.name!r}, "
                    "which the input does not produce",
                )
            out[name] = ci
        else:
            out[name] = ColInfo(expr_dtype(e, child, p))
    return out


def _join_schema(p: ir.Join, db, kids: list[Schema]) -> Schema:
    stream, build = kids
    if p.kind in ("semi", "anti"):
        return stream
    out = dict(stream)
    for name, ci in build.items():
        out.setdefault(name, ci)
    return out


def _agg_schema(p: ir.Agg, db, kids: list[Schema]) -> Schema:
    child = kids[0]
    out = {}
    for name in list(p.group_by) + list(p.carry):
        ci = child.get(name)
        if ci is None:
            raise SchemaError(
                p, f"group/carry column {name!r} is not produced by the input"
            )
        out[name] = ci
    for spec in p.aggs:
        if spec.fn == "count":
            dt = "int"
        elif spec.fn == "avg":
            dt = "float"
        elif spec.expr is not None:
            dt = expr_dtype(spec.expr, child, p)
        else:
            dt = "int"
        out[spec.name] = ColInfo(dt)
    return out


# analyze() runs per pass per optimize: dispatch on type, not an
# isinstance chain (measurably cheaper on the ~10-node TPC-H plans)
_SCHEMA_FNS = {
    ir.Scan: _scan_schema,
    ir.Select: _passthrough_schema,
    ir.Compact: _passthrough_schema,
    ir.Exchange: _passthrough_schema,
    ir.Sort: _passthrough_schema,
    ir.Limit: _passthrough_schema,
    ir.Project: _project_schema,
    ir.Join: _join_schema,
    ir.Agg: _agg_schema,
}


def node_schema(p: ir.Plan, db, kids: list[Schema]) -> Schema:
    """Output schema of `p` given its children's schemas (one dataflow
    step; `schema_of` / `analysis.properties.analyze` run the fixpoint)."""
    fn = _SCHEMA_FNS.get(type(p))
    if fn is None:
        raise TypeError(type(p))
    return fn(p, db, kids)


def schema_of(p: ir.Plan, db) -> Schema:
    """Output schema of a plan subtree (un-memoized convenience wrapper —
    use `analysis.properties.analyze` when querying many nodes)."""
    return node_schema(p, db, [schema_of(c, db) for c in ir.children(p)])
