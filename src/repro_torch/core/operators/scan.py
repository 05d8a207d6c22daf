"""Scan: base-table access with per-query specialized loading (§3.6.1).

Registers exactly the columns the optimized plan references as inputs of
the staged program and applies the date-clustered permutation slice when
DateIndex annotated one (§3.2.3).  Only the column layout is ported: the
AoS record-matrix layout (`Settings.layout="row"`) raises.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.operators.base import Binding, Frame, StageCtx
from repro_torch.relational.schema import ColKind


def stage(scan: ir.Scan, ctx: StageCtx, defer: bool = False) -> Frame:
    db, be, s = ctx.db, ctx.backend, ctx.settings
    if s.layout == "row":
        raise NotImplementedError(
            "layout='row' is not ported to repro_torch yet")
    if scan.shard is not None:
        raise NotImplementedError(
            "sharded scans are not ported to repro_torch yet")
    t = db.table(scan.table)
    cols = scan.columns if scan.columns is not None else t.schema.column_names

    def reg(suffix, thunk):
        return ctx.input(f"{scan.table}/{suffix}", thunk)

    perm = None
    if scan.date_slice is not None:
        ds = scan.date_slice
        _, start, end = db.date_slice(scan.table, ds.col, ds.lo, ds.hi)
        pfull = ctx.input(f"{scan.table}/dateperm/{ds.col}",
                          lambda: db.date_cluster(scan.table, ds.col)[0])
        perm = pfull[min(start, pfull.shape[0]):min(end, pfull.shape[0])]

    bindings: dict[str, Binding] = {}
    for c in cols:
        cdef = t.schema.col(c)
        if cdef.kind in (ColKind.INT, ColKind.FLOAT, ColKind.DATE):
            arr, kind = reg(f"col/{c}", lambda c=c: t.data[c]), "num"
        elif cdef.kind == ColKind.CAT:
            if s.string_dict:
                arr, kind = reg(f"col/{c}", lambda c=c: t.data[c]), "codes"
            else:
                arr = reg(f"chars/{c}", lambda c=c: t.char_matrix(c))
                kind = "chars"
        else:  # TEXT
            if s.string_dict:
                arr, kind = reg(f"col/{c}", lambda c=c: t.data[c]), "words"
            else:
                arr = reg(f"chars/{c}", lambda c=c: t.char_matrix(c))
                kind = "wordchars"
        if perm is not None:
            arr = be.take(arr, perm)
        bindings[c] = Binding(arr, kind, t, c)
    return Frame(bindings)
