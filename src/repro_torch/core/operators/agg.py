"""Aggregation: the three lowered strategies of §3.2.2.

  scalar  — no group key: accumulators are scalar registers (optionally the
            fused filter+agg kernel);
  dense   — statically-known key domains: the hash map is a pre-allocated
            array indexed by a mixed-radix composite of the key codes;
  generic — the un-specialized hash map as a sort: rows ordered by their
            group keys, one group per run of equal keys, the result
            padded to the input's row count.
"""
from __future__ import annotations

import torch

from repro_torch.core import ir
from repro_torch.core.expr import eval_expr
from repro_torch.core.operators import fused as fu
from repro_torch.core.operators.base import (Binding, F32BIG, Frame,
                                             StageCtx, and_masks, frame_nrows)

# dense domains up to this many groups go through the aggregation kernels
# (their per-block accumulators live in shared memory)
KERNEL_MAX_GROUPS = 4096


def _dense_domain(a: ir.Agg) -> int:
    D = 1
    for d in a.domains:
        D *= d
    return D


def _radix(a: ir.Agg) -> list[tuple[str, int, int]]:
    """(group column, domain, stride) of the mixed-radix composite index
    (strides baked at staging time, last key fastest)."""
    strides = []
    st = 1
    for d in reversed(a.domains):
        strides.append(st)
        st *= d
    return list(zip(a.group_by, a.domains, reversed(strides)))


def _key_columns(a: ir.Agg, f: Frame, ctx: StageCtx, D: int) -> dict:
    """The decoded group-key columns of a dense result over `D` slots."""
    ar = ctx.arange(D)
    cols: dict[str, Binding] = {}
    for g, d, stg in _radix(a):
        b = f.cols[g]
        cols[g] = Binding((ar // stg) % d, b.kind, b.table, b.col)
    return cols


def _fusible(a: ir.Agg, ctx: StageCtx) -> bool:
    """Can this Agg absorb its child Select into the selective pipeline
    kernel?  Structure is checked BEFORE anything stages (the Select must
    never stage twice); operand shapes are re-checked after."""
    if not ctx.use_kernels:
        return False
    if not isinstance(a.child, ir.Select):
        return False
    if not (fu.elementwise_chain(a.child.child)
            and fu.kernel_safe(a.child.pred)):
        return False
    if not all(sp.fn in ("sum", "count", "avg") for sp in a.aggs):
        return False
    if not all(sp.expr is None or fu.kernel_safe(sp.expr) for sp in a.aggs):
        return False
    if a.strategy == "scalar" or not a.group_by:
        return True
    return (a.strategy == "dense" and not a.carry
            and _dense_domain(a) <= KERNEL_MAX_GROUPS)


def _fused_stage(a: ir.Agg, f: Frame, pred, ctx: StageCtx):
    """Stage the q6/q19-class selective pipeline: predicate + grouped
    aggregation in ONE kernel pass, no mask ever materialized.  Returns
    None when operand collection fails (caller falls back)."""
    names = [sp.name for sp in a.aggs if sp.expr is not None]
    val_exprs = [sp.expr for sp in a.aggs if sp.expr is not None]
    operands = fu.collect_operands(f, [pred] + val_exprs,
                                   list(a.group_by), ctx)
    if operands is None:
        return None
    cols_d, scalars, pnames = operands
    gidx_fn = None
    n_groups = 1
    if a.group_by:                        # dense: mixed-radix in-kernel
        n_groups = _dense_domain(a)
        gidx_fn = fu.GroupIndex(_radix(a), n_groups)
    sums_m, cnt, _total = ctx.kernel(
        "selective_agg_query", cols_d, scalars, fu.TileFn(pred, pnames),
        [fu.TileFn(e, pnames) for e in val_exprs], gidx_fn, n_groups)
    if f.part is not None:
        sums_m = ctx.backend.psum(sums_m, ctx.axis)
        cnt = ctx.backend.psum(cnt, ctx.axis)

    def agg_col(spec, row):
        if spec.fn == "sum":
            return sums_m[row, names.index(spec.name)]
        if spec.fn == "count":
            return cnt[row]
        return (sums_m[row, names.index(spec.name)]
                / cnt[row].clamp_min(1).to(torch.float32))

    if not a.group_by:
        return Frame({sp.name: Binding(agg_col(sp, slice(0, 1)), "num")
                      for sp in a.aggs})
    cols = _key_columns(a, f, ctx, n_groups)
    for sp in a.aggs:
        cols[sp.name] = Binding(agg_col(sp, slice(None)), "num")
    return Frame(cols, cnt > 0)


def stage(a: ir.Agg, ctx: StageCtx, defer: bool = False) -> Frame:
    be = ctx.backend
    pred = None
    if _fusible(a, ctx):
        pred = a.child.pred
        f = ctx.stage(a.child.child)
        if f.mask is not None or f.pending:
            # the chain carried state the kernel can't see — evaluate the
            # intercepted predicate the ordinary way instead
            f.mask = and_masks(f.mask, eval_expr(pred, ctx.env(f)))
            pred = None
    else:
        f = ctx.stage(a.child)
    if pred is not None:
        out = _fused_stage(a, f, pred, ctx)
        if out is not None:
            return out
        f.mask = and_masks(f.mask, eval_expr(pred, ctx.env(f)))
    n = frame_nrows(f)
    env = ctx.env(f)
    mask = f.mask if f.mask is not None else ctx.ones(n)
    mi32 = mask.to(torch.int32)
    vals = {}
    for spec in a.aggs:
        if spec.expr is not None:
            vals[spec.name] = eval_expr(spec.expr, env)

    def _finalize(spec, sums, counts, mins, maxs):
        if spec.fn == "sum":
            return sums[spec.name]
        if spec.fn == "count":
            return counts[spec.name]
        if spec.fn == "avg":
            c = counts[spec.name]
            return sums[spec.name] / c.clamp_min(1).to(torch.float32)
        if spec.fn == "min":
            return mins[spec.name]
        if spec.fn == "max":
            return maxs[spec.name]
        raise ValueError(spec.fn)

    def _kernel_ok(D):
        return (ctx.use_kernels and D <= KERNEL_MAX_GROUPS
                and all(s_.fn in ("sum", "count", "avg") for s_ in a.aggs)
                and all(getattr(v, "ndim", 0) == 1 for v in vals.values()))

    def _kernel_agg(gidx, D):
        names = [s_.name for s_ in a.aggs if s_.expr is not None]
        # the kernel reads contiguous value columns: a bare column of a
        # row-layout record matrix is copied out here, in the query's time
        sums_m, cnt = ctx.kernel(
            "filter_agg_query", mask, gidx,
            [vals[nm].to(torch.float32).contiguous() for nm in names], D)
        if f.part is not None:
            sums_m = be.psum(sums_m, ctx.axis)
            cnt = be.psum(cnt, ctx.axis)
        return ({nm: sums_m[:, i] for i, nm in enumerate(names)}, cnt)

    if a.strategy == "scalar" or not a.group_by:
        # (the 'scalar' annotation additionally enables kernel fusion;
        # functionally an empty group-by is always a single group)
        if _kernel_ok(1):
            ksums, cnt = _kernel_agg(
                torch.zeros((n,), dtype=torch.int32, device=mask.device), 1)
            cols = {}
            for spec in a.aggs:
                if spec.fn == "sum":
                    v = ksums[spec.name][0:1]
                elif spec.fn == "count":
                    v = cnt[0:1]
                else:  # avg
                    v = ksums[spec.name][0:1] / cnt[0:1].clamp_min(1).to(
                        torch.float32)
                cols[spec.name] = Binding(v, "num")
            return Frame(cols)
        # partitioned input: every reduction is computed over the local
        # shard and combined with the matching collective BEFORE any
        # finalization (avg divides psum(sum) by psum(count)), so the
        # output is bit-identical on every shard — replicated, no Exchange
        combine = f.part is not None

        def psum(v):
            return be.psum(v, ctx.axis) if combine else v

        cols = {}
        for spec in a.aggs:
            if spec.fn == "count":
                v = psum(mi32.sum(dtype=torch.int32))
            elif spec.fn == "sum":
                v = psum(torch.where(mask, vals[spec.name], 0).sum())
            elif spec.fn == "avg":
                sv = psum(torch.where(mask, vals[spec.name], 0).sum())
                cv = psum(mi32.sum(dtype=torch.int32))
                v = sv / cv.clamp_min(1).to(torch.float32)
            elif spec.fn == "min":
                v = torch.where(mask, vals[spec.name], F32BIG).min()
                if combine:
                    v = be.pmin(v, ctx.axis)
            elif spec.fn == "max":
                v = torch.where(mask, vals[spec.name], -F32BIG).max()
                if combine:
                    v = be.pmax(v, ctx.axis)
            cols[spec.name] = Binding(v[None], "num")
        return Frame(cols)

    if a.strategy != "dense":
        return _generic(a, f, mask, vals, ctx, _finalize)
    D = _dense_domain(a)
    # mixed-radix composite index (strides baked at staging time)
    idx = None
    for g, _d, stg in _radix(a):
        part = f.cols[g].arr.to(torch.int32) * stg
        idx = part if idx is None else idx + part
    idx = idx.clamp(0, D - 1)
    if _large_domain_kernel_ok(a, f, ctx, D, vals):
        return _one_pass(a, f, ctx, mask, idx, vals, D, kernel=True)
    kernel_sums = kernel_counts = None
    if _kernel_ok(D):
        kernel_sums, kernel_counts = _kernel_agg(idx, D)
        present = (kernel_counts > 0).to(torch.int32)
    elif _one_pass_ok(a, f, vals):
        return _one_pass(a, f, ctx, mask, idx, vals, D, kernel=False)
    else:
        present = be.segment_max(mi32, idx, D, 0)
        if f.part is not None:
            present = be.pmax(present, ctx.axis)
    cols = _key_columns(a, f, ctx, D)
    combine = f.part is not None
    for c in a.carry:
        b = f.cols[c]
        if b.arr.ndim == 2:
            data = torch.where(mask[:, None], b.arr, 0)
            carried = be.segment_max(data, idx, D, 0)
        elif b.arr.dtype.is_floating_point:
            # the cross-shard combine below is a pmax: the empty-slot
            # fill must be max's identity, or a shard holding none of a
            # group's rows would beat the real (negative) carry with a 0
            carried = be.segment_max(torch.where(mask, b.arr, -F32BIG),
                                     idx, D, -F32BIG if combine else 0.0)
        else:
            data = torch.where(mask, b.arr, -1).to(b.arr.dtype)
            carried = be.segment_max(data, idx, D, -1 if combine else 0)
        if combine:
            # a group's rows may straddle shards; max-combining matches
            # the single-device carry-via-max semantics
            carried = be.pmax(carried, ctx.axis)
        cols[c] = Binding(carried, b.kind, b.table, b.col)
    sums, counts, mins, maxs = {}, {}, {}, {}
    for spec in a.aggs:
        if spec.fn in ("sum", "avg"):
            sums[spec.name] = (kernel_sums[spec.name]
                               if kernel_sums is not None else
                               be.segment_sum(
                                   torch.where(mask, vals[spec.name], 0),
                                   idx, D))
        if spec.fn in ("count", "avg"):
            counts[spec.name] = (kernel_counts
                                 if kernel_counts is not None else
                                 be.segment_sum(mi32, idx, D))
        if spec.fn == "min":
            mins[spec.name] = be.segment_min(
                torch.where(mask, vals[spec.name], F32BIG), idx, D, F32BIG)
        if spec.fn == "max":
            maxs[spec.name] = be.segment_max(
                torch.where(mask, vals[spec.name], -F32BIG), idx, D,
                -F32BIG)
    if combine and kernel_sums is None:
        # shard-local partials -> replicated totals, combined before
        # _finalize so avg divides global sum by global count
        sums = {k: be.psum(v, ctx.axis) for k, v in sums.items()}
        counts = {k: be.psum(v, ctx.axis) for k, v in counts.items()}
        mins = {k: be.pmin(v, ctx.axis) for k, v in mins.items()}
        maxs = {k: be.pmax(v, ctx.axis) for k, v in maxs.items()}
    for spec in a.aggs:
        cols[spec.name] = Binding(
            _finalize(spec, sums, counts, mins, maxs), "num")
    return Frame(cols, present > 0)


def _one_pass_ok(a: ir.Agg, f: Frame, vals: dict) -> bool:
    """Is a dense aggregation one call of the large-domain aggregation
    (`kernels/dense_agg.py`: the kernel, or its plain version, the
    segment operations)?  An unsharded frame (a sharded one combines its
    partials with collectives), sums, counts and averages of 1-D
    columns, and 1-D carries."""
    return (f.part is None
            and all(s_.fn in ("sum", "count", "avg") for s_ in a.aggs)
            and all(getattr(v, "ndim", 0) == 1 for v in vals.values())
            and all(f.cols[c].arr.ndim == 1 for c in a.carry))


def _large_domain_kernel_ok(a: ir.Agg, f: Frame, ctx: StageCtx, D: int,
                            vals: dict) -> bool:
    """Does a dense aggregation past `KERNEL_MAX_GROUPS` take the
    large-domain kernel?  On the hand-kernel rung, one pass
    (`_one_pass_ok`) of float32 columns and int32 or float32 carries, at
    most a launch's columns of each."""
    from repro_torch.kernels import dense_agg

    carries = [f.cols[c].arr for c in a.carry]
    return (ctx.use_kernels and D > KERNEL_MAX_GROUPS
            and _one_pass_ok(a, f, vals)
            and all(v.dtype == torch.float32 for v in vals.values())
            and all(c.dtype in dense_agg.CARRY_DTYPES for c in carries)
            and dense_agg.fits(len(vals), len(carries)))


def _one_pass(a: ir.Agg, f: Frame, ctx: StageCtx, mask, idx, vals: dict,
              D: int, kernel: bool) -> Frame:
    """Sums, counts and carries of a dense domain in one call: the
    kernel's entry point, or its plain version.  The entry point is
    called directly, not through `ctx.kernel`: it takes no runtime
    parameter, so a captured walk keeps its launches inside the segment
    instead of cutting one there."""
    from repro_torch.kernels import dense_agg, ops

    names = [s_.name for s_ in a.aggs if s_.expr is not None]
    values = [vals[nm] for nm in names]
    carries = [f.cols[c].arr for c in a.carry]
    if kernel:
        sums, counts, carried = ops.dense_agg_query(
            mask, idx, [v.contiguous() for v in values],
            [c.contiguous() for c in carries], D)
    else:
        sums, counts, carried = dense_agg.dense_agg_plain(
            mask, idx, values, carries, D)
    cols = _key_columns(a, f, ctx, D)
    for c, arr in zip(a.carry, carried):
        b = f.cols[c]
        cols[c] = Binding(arr, b.kind, b.table, b.col)
    for spec in a.aggs:
        if spec.fn == "count":
            v = counts
        else:
            v = sums[names.index(spec.name)]
            if spec.fn == "avg":
                v = v / counts.clamp_min(1).to(torch.float32)
        cols[spec.name] = Binding(v, "num")
    return Frame(cols, counts > 0)


def _generic(a: ir.Agg, f: Frame, mask, vals: dict, ctx: StageCtx,
             finalize) -> Frame:
    """Sort-based grouping: a lexsort over the group keys (a char-matrix
    key contributes one key per byte column) with the invalid rows last,
    group ids from the cumulative sum of key changes, and segment sums,
    counts, mins and maxes over them.  The frame keeps the input's row
    count; its first `n_groups` rows are the groups in key order."""
    if f.part is not None:
        from repro_torch.core.analysis import PlanInvariantError

        raise PlanInvariantError(
            "shard-invariance",
            "generic (sort-based) aggregation over a partitioned frame "
            "would group each shard independently — needs a gather "
            "Exchange", node=a, pass_name="staging")
    be = ctx.backend
    n = frame_nrows(f)
    sort_keys: list = []   # major..minor
    for g in a.group_by:
        arr = f.cols[g].arr
        if arr.ndim == 2:
            sort_keys.extend(arr[:, k] for k in range(arr.shape[1]))
        else:
            sort_keys.append(arr)
    order = be.lexsort(list(reversed(sort_keys)) + [~mask])
    smask = be.take(mask, order)
    new_group = None
    for k in sort_keys:
        sk = be.take(k, order)
        d = torch.cat([torch.ones(1, dtype=torch.bool, device=sk.device),
                       sk[1:] != sk[:-1]])
        new_group = d if new_group is None else new_group | d
    new_group = new_group & smask
    # an invalid row is a group of its own past the valid ones
    gid = torch.cumsum((new_group | ~smask).to(torch.int32), 0,
                       dtype=torch.int32) - 1
    n_groups = new_group.sum(dtype=torch.int32)
    ar = ctx.arange(n)
    starts = be.segment_min(ar, gid, n, 0)
    first = be.take(order, starts)      # each group's first row
    cols = {}
    for g in list(a.group_by) + list(a.carry):
        b = f.cols[g]
        cols[g] = Binding(be.take(b.arr, first), b.kind, b.table, b.col)
    sums, counts, mins, maxs = {}, {}, {}, {}
    cnt = None
    for spec in a.aggs:
        sv = be.take(vals[spec.name], order) if spec.expr is not None \
            else None
        if spec.fn in ("sum", "avg"):
            sums[spec.name] = be.segment_sum(torch.where(smask, sv, 0),
                                             gid, n)
        if spec.fn in ("count", "avg"):
            if cnt is None:
                cnt = be.segment_sum(smask.to(torch.int32), gid, n)
            counts[spec.name] = cnt
        if spec.fn == "min":
            mins[spec.name] = be.segment_min(
                torch.where(smask, sv, F32BIG), gid, n, F32BIG)
        if spec.fn == "max":
            maxs[spec.name] = be.segment_max(
                torch.where(smask, sv, -F32BIG), gid, n, -F32BIG)
    for spec in a.aggs:
        cols[spec.name] = Binding(
            finalize(spec, sums, counts, mins, maxs), "num")
    return Frame(cols, ar < n_groups)
