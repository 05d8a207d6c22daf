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
    t = db.table(scan.table)
    cols = scan.columns if scan.columns is not None else t.schema.column_names

    # Sharding-pass annotation: this scan's arrays live partitioned over
    # the data axis.  Partitioned copies are registered under shard-scoped
    # input keys (so the same table can also feed a replicated scan in
    # another plan without key collisions) and recorded in
    # `ctx.sharded_keys` — compile.py splits those into per-shard blocks.
    # The pass never co-annotates a date_slice (the clustered permutation
    # is global) so the two paths don't interact.
    sp = None
    if scan.shard is not None:
        sp = db.shard_plan(scan.shard.n_shards)

    def reg(suffix, thunk):
        if sp is None:
            return ctx.input(f"{scan.table}/{suffix}", thunk)
        key = f"{scan.table}/shard{sp.n}/{suffix}"
        ctx.sharded_keys.add(key)
        return ctx.input(key, lambda: sp.col(scan.table, suffix, thunk))

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
    if sp is None:
        return Frame(bindings)
    mkey = f"{scan.table}/shard{sp.n}/mask"
    ctx.sharded_keys.add(mkey)
    mask = ctx.input(mkey, lambda: sp.valid_mask(scan.table))
    return Frame(bindings, mask, part=scan.shard.part)
