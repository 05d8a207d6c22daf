"""Join: the four lowered strategies of §3.2.1.

  pk_gather     — PK/FK equi-join as a vectorized gather (the 1-D
                  partitioned array is the parent table itself);
  bucket_gather — composite-PK join probing the load-time 2-D partitioned
                  array (bucket on key1, discriminate on key2);
  exists_flag   — semi/anti membership via a dense flag over the key
                  domain;
  generic       — sort + binary-search equi-join (unique build keys).
"""
from __future__ import annotations

import torch

from repro_torch.core import ir
from repro_torch.core.expr import eval_expr
from repro_torch.core.operators.base import (Binding, Frame, StageCtx,
                                             and_masks, frame_nrows)

I32MAX = 2**31 - 1
# the composite pack's sentinel: above every packed key (`_key2_bound`
# keeps the packs below 2^32 - 1), as the reference's uint32 one is
PACK_SENTINEL = 2**32 - 1


def _apply_pending(out: Frame, build: Frame, ctx: StageCtx) -> None:
    if build.pending:
        env = ctx.env(out)
        for pred in build.pending:
            out.mask = and_masks(out.mask, eval_expr(pred, env))


def stage(j: ir.Join, ctx: StageCtx, defer: bool = False) -> Frame:
    stream = ctx.stage(j.stream)
    if j.strategy == "pk_gather":
        return _pk_gather(j, stream, ctx)
    if j.strategy == "bucket_gather":
        return _bucket_gather(j, stream, ctx)
    if j.strategy == "exists_flag":
        return _exists_flag(j, stream, ctx)
    return _generic(j, stream, ctx)


def _pk_gather(j: ir.Join, stream: Frame, ctx: StageCtx) -> Frame:
    be = ctx.backend
    build = ctx.stage(j.build, defer=not ctx.settings.hoist)
    if build.slot_of is not None:
        # compacted (translate) build side: the parent-positional
        # addressing pk_gather relies on is gone, so probe the CSR
        # key→slot vector first — slot_of lives on the parent row domain,
        # its values address the compacted frame.  A slot of -1 is a
        # mask-invalid parent row; a slot >= n_b is a row the compaction
        # overflowed past capacity (dropped here, but the point's count
        # already exceeds capacity so the runtime re-executes the
        # uncompacted fallback — never a wrong answer).
        n_b = frame_nrows(build)
        slot = be.take(build.slot_of, stream.cols[j.stream_key].arr)
        idx = slot.clamp(0, n_b - 1)
        bmask_g = (slot >= 0) & (slot < n_b)
        if build.mask is not None:
            bmask_g = bmask_g & be.take(build.mask, idx)
    else:
        idx = stream.cols[j.stream_key].arr
        bmask_g = None
        if build.mask is not None:
            bmask_g = be.take(build.mask, idx)
    cols = dict(stream.cols)
    for name, b in build.cols.items():
        if name in cols:
            continue
        g = be.take(b.arr, idx)
        if j.kind == "left" and bmask_g is not None and g.ndim == 1:
            g = torch.where(bmask_g, g, 0)  # missing match -> default 0
        cols[name] = Binding(g, b.kind, b.table, b.col)
    mask = stream.mask
    if j.kind != "left" and bmask_g is not None:
        mask = and_masks(mask, bmask_g)
    out = Frame(cols, mask)
    _apply_pending(out, build, ctx)
    return out


def _bucket_gather(j: ir.Join, stream: Frame, ctx: StageCtx) -> Frame:
    """Composite-PK join via the load-time 2-D partitioned array: bucket
    on key1, discriminate on key2 within the static bucket width."""
    be = ctx.backend
    build = ctx.stage(j.build, defer=not ctx.settings.hoist)
    mat = ctx.input(
        f"{j.build_table}/fkbucket/{j.build_key}",
        lambda: ctx.db.fk_bucket(j.build_table, j.build_key)[0])
    rows = be.take(mat, stream.cols[j.stream_key].arr)   # (n, W)
    bkey2 = build.cols[j.build_key2].arr
    skey2 = stream.cols[j.stream_key2].arr
    idx = hit = None
    for slot in range(j.bucket_width):
        r = rows[:, slot]
        rc = r.clamp_min(0)
        m = (r >= 0) & (be.take(bkey2, rc) == skey2)
        if build.mask is not None:
            m = m & be.take(build.mask, rc)
        idx = torch.where(m, r, 0 if idx is None else idx)
        hit = m if hit is None else hit | m
    cols = dict(stream.cols)
    for name, b in build.cols.items():
        if name not in cols:
            cols[name] = Binding(be.take(b.arr, idx), b.kind, b.table, b.col)
    out = Frame(cols, and_masks(stream.mask, hit))
    _apply_pending(out, build, ctx)
    return out


def _exists_flag(j: ir.Join, stream: Frame, ctx: StageCtx) -> Frame:
    """Semi/anti membership: a dense flag per key value over the key
    domain, set where a valid build row holds that key, then gathered at
    the stream's keys."""
    be = ctx.backend
    build = ctx.stage(j.build)
    n_b = frame_nrows(build)
    bm = build.mask if build.mask is not None else ctx.ones(n_b)
    flags = be.segment_max(bm.to(torch.int32), build.cols[j.build_key].arr,
                           j.domain, 0) > 0
    hit = be.take(flags, stream.cols[j.stream_key].arr)
    if j.kind == "anti":
        hit = ~hit
    stream.mask = and_masks(stream.mask, hit)
    return stream


def _generic(j: ir.Join, stream: Frame, ctx: StageCtx) -> Frame:
    """Sort + binary-search equi-join over unique build keys.  Composite
    keys pack as k1 * K2 + k2 in int64 (the reference packs in uint32,
    which torch does not sort on the CPU); `_key2_bound` keeps every pack
    below 2^32 - 1, so the same plans compile in both packages and the
    sentinel stays above every packed key."""
    be = ctx.backend
    build = ctx.stage(j.build)
    n_b = frame_nrows(build)
    if j.stream_key2 is not None:
        k2b = _key2_bound(j, stream, build)

        def pack(f, k1, k2):
            return (f.cols[k1].arr.to(torch.int64) * k2b
                    + f.cols[k2].arr.to(torch.int64))

        bkey = pack(build, j.build_key, j.build_key2)
        skey = pack(stream, j.stream_key, j.stream_key2)
        sentinel = PACK_SENTINEL
    else:
        bkey = build.cols[j.build_key].arr.to(torch.int32)
        skey = stream.cols[j.stream_key].arr.to(torch.int32)
        sentinel = I32MAX
    if build.mask is not None:
        bkey = torch.where(build.mask, bkey, sentinel)
    # stable: the build keys are unique, so ties fall only among masked
    # rows at the sentinel, but one order on every device
    order = torch.argsort(bkey, stable=True)
    skeys = be.take(bkey, order)
    pos = be.searchsorted(skeys, skey).clamp(0, max(n_b - 1, 0))
    hit = be.take(skeys, pos) == skey
    if j.kind in ("semi", "anti"):
        stream.mask = and_masks(stream.mask, hit if j.kind == "semi"
                                else ~hit)
        return stream
    bidx = be.take(order, pos)
    cols = dict(stream.cols)
    for name, b in build.cols.items():
        if name in cols:
            continue
        g = be.take(b.arr, bidx)
        if j.kind == "left" and g.ndim == 1:
            g = torch.where(hit, g, 0)
        cols[name] = Binding(g, b.kind, b.table, b.col)
    mask = stream.mask if j.kind == "left" else and_masks(stream.mask, hit)
    return Frame(cols, mask)


def _stats_max(frame: Frame, key: str):
    b = frame.cols[key]
    if b.table is not None and b.col in b.table.stats:
        return int(b.table.stats[b.col].max)
    return None


def _key2_bound(j: ir.Join, stream: Frame, build: Frame) -> int:
    """Static bound K2 for the second key of a composite-key pack.

    K2 must exceed both sides' k2 values or distinct pairs collide, and
    the packed value must stay below 2^32, the reference's uint32 pack.
    Both bounds come from `analysis.composite_pack_bound` (the verifier's
    final-only `key-pack` rule applies the same arithmetic at optimize
    time); staging re-checks against the staged frames' provenance, so a
    pack the reference refuses never compiles here either, even on
    hand-built plans that bypassed the pipeline.
    """
    from repro_torch.core.analysis import (PlanInvariantError,
                                           composite_pack_bound)

    k1_maxes = [m for m in (_stats_max(build, j.build_key),
                            _stats_max(stream, j.stream_key))
                if m is not None]
    k2_maxes = [m for m in (_stats_max(build, j.build_key2),
                            _stats_max(stream, j.stream_key2))
                if m is not None]
    K2, packed_max = composite_pack_bound(
        max(k1_maxes) if k1_maxes else None, k2_maxes)
    if packed_max is not None and packed_max >= 2**32:
        raise PlanInvariantError(
            "key-pack",
            f"composite join key ({j.stream_key},{j.stream_key2}) "
            f"cannot pack into uint32: max_k1={max(k1_maxes)} * "
            f"K2={K2} + {K2 - 1} = {packed_max} >= 2**32; "
            "the generic composite strategy needs a wider pack",
            node=j, pass_name="staging")
    return int(K2)
