"""Scan: base-table access with per-query specialized loading (§3.6.1).

Registers exactly the columns the optimized plan references as inputs of
the staged program and applies the date-clustered permutation slice when
DateIndex annotated one (§3.2.3).  Under the AoS layout
(`Settings.layout="row"`, §3.3) the numeric columns come from one record
matrix per dtype group, and each column is a strided view into it: every
read of a column is a read through its records, which is what the rung
measures (eager torch has no optimization barrier to force the whole
record, and the views are never made contiguous here).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ir
from repro_torch.core.operators.base import Binding, Frame, StageCtx
from repro_torch.relational.schema import ColKind


def stage(scan: ir.Scan, ctx: StageCtx, defer: bool = False) -> Frame:
    db, be, s = ctx.db, ctx.backend, ctx.settings
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

    rowmats: dict[str, tuple] = {}   # dtype group -> (record matrix, cols)
    if s.layout == "row":
        # one record matrix PER DTYPE GROUP: integers through a float32
        # matrix would lose every value above 2^24
        groups: dict[str, list[str]] = {"int": [], "float": []}
        for c in cols:
            k = t.schema.col(c).kind
            if k in (ColKind.INT, ColKind.DATE):
                groups["int"].append(c)
            elif k == ColKind.FLOAT:
                groups["float"].append(c)
        for g, gcols in groups.items():
            if not gcols:
                continue
            dt = np.int32 if g == "int" else np.float32
            mat = reg(f"rowmat/{g}/" + ",".join(gcols),
                      lambda gcols=gcols, dt=dt: np.stack(
                          [t.data[c].astype(dt) for c in gcols], axis=1))
            if perm is not None:
                mat = be.take(mat, perm)
            rowmats[g] = (mat, gcols)

    bindings: dict[str, Binding] = {}
    for c in cols:
        cdef = t.schema.col(c)
        if cdef.kind in (ColKind.INT, ColKind.FLOAT, ColKind.DATE):
            g = "float" if cdef.kind == ColKind.FLOAT else "int"
            if g in rowmats:
                mat, gcols = rowmats[g]
                bindings[c] = Binding(mat[:, gcols.index(c)], "num", t, c)
                continue
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
