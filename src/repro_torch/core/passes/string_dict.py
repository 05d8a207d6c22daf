"""String dictionaries (paper §3.4, Table II).

Rewrites char-matrix string predicates into integer predicates over the
load-time dictionary codes:

  StrEq(c, s)            -> CodeEq(c, dict[s])          (Normal dictionary)
  StrIn(c, ss)           -> CodeIn(c, codes)
  StrStartsWith(c, p)    -> CodeRange(c, lo, hi)        (Ordered dictionary:
                            the vocab is sorted, so a prefix is a code range)
  StrContainsWord(c, w)  -> WordCode(c, word_dict[w])   (Word-tokenizing
                            dictionary: per-row word-code matrix membership)

A constant absent from the dictionary lowers to the empty/full predicate
(code −1 matches nothing).  TPC-H column names are globally unique, so the
owning table is resolved by schema lookup.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.expr import (CodeEq, CodeIn, CodeRange, StrContainsWord,
                             StrEq, StrIn, StrStartsWith, WordCode)
from repro_torch.core.passes.cse_dce import transform_exprs
from repro_torch.relational.loader import Database


def _owner(db: Database, col: str, renames: dict[str, str]):
    seen = set()
    while col in renames and col not in seen:
        seen.add(col)
        col = renames[col]
    for t in db.tables.values():
        if t.schema.has_col(col):
            return t, col
    raise KeyError(f"column {col} not found in any table")


class StringDictionary:
    name = "StringDictionary"

    def run(self, plan: ir.Plan, db: Database, settings) -> ir.Plan:
        from repro_torch.core.expr import Col

        renames: dict[str, str] = {}
        for node in ir.walk(plan):
            if isinstance(node, ir.Project):
                for name, e in node.outputs.items():
                    if isinstance(e, Col) and e.name != name:
                        renames[name] = e.name

        def lower(e):
            return _lower(e, db, renames)

        transform_exprs(plan, lambda e: _map_tree(e, lower))
        return plan


def _map_tree(e, fn):
    from repro_torch.core import expr as E

    if isinstance(e, (E.Arith, E.Cmp)):
        return type(e)(e.op, _map_tree(e.lhs, fn), _map_tree(e.rhs, fn))
    if isinstance(e, (E.And, E.Or)):
        return type(e)(_map_tree(e.lhs, fn), _map_tree(e.rhs, fn))
    if isinstance(e, E.Not):
        return E.Not(_map_tree(e.operand, fn))
    if isinstance(e, E.Where):
        return E.Where(_map_tree(e.cond, fn), _map_tree(e.then, fn),
                       _map_tree(e.other, fn))
    return fn(e)


def _lower(e, db: Database, renames: dict[str, str]):
    from repro_torch.core.expr import Param

    if isinstance(e, (StrEq, StrIn, StrStartsWith, StrContainsWord)):
        # An unbound string Param has no dictionary code yet: leave the
        # predicate unlowered (param-residual).  Execution requires the
        # value, so the runtime layer substitutes string params before
        # optimization; this branch only matters for plan analysis.
        vals = {StrEq: lambda: [e.value], StrIn: lambda: list(e.values),
                StrStartsWith: lambda: [e.prefix],
                StrContainsWord: lambda: [e.word]}[type(e)]()
        if any(isinstance(v, Param) for v in vals):
            return e
    if isinstance(e, StrEq):
        t, c = _owner(db, e.col, renames)
        return CodeEq(e.col, t.encode_const(c, e.value), e.negate)
    if isinstance(e, StrIn):
        t, c = _owner(db, e.col, renames)
        return CodeIn(e.col, tuple(t.encode_const(c, v) for v in e.values))
    if isinstance(e, StrStartsWith):
        t, c = _owner(db, e.col, renames)
        lo, hi = t.code_range(c, e.prefix)
        return CodeRange(e.col, lo, hi)
    if isinstance(e, StrContainsWord):
        t, c = _owner(db, e.col, renames)
        return WordCode(e.col, t.encode_word(c, e.word), e.negate)
    return e
