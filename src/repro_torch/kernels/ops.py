"""The engine's entry points into the kernels (the reference's
`kernels/ops.py` surface).

`filter_agg_query` is the integration point of scalar and dense
aggregation; `compact_query`, `compact_pred_query` and
`selective_agg_query` those of `operators.compact` and the fused
selective pipeline.  Which version runs follows the tensors' device and
nothing else: CPU tensors take the plain torch versions, CUDA tensors
launch the hand kernels (or the call raises).  `calls` counts the calls
of each entry point whichever version ran; the kernel modules'
`launches` count CUDA launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.compact import compact, compact_pred
from repro_torch.kernels.filter_agg import filter_agg, selective_filter_agg

__all__ = ["calls", "filter_agg_query", "compact_query",
           "compact_pred_query", "selective_agg_query"]

calls = {"filter_agg": 0, "compact": 0, "compact_pred": 0,
         "selective_agg": 0}


def filter_agg_query(mask, gidx, value_cols, n_groups):
    """Aggregate a list of 1-D value columns and count the rows per group
    in one kernel pass.  Returns (sums (G, A), counts (G,)) in float32,
    as the reference's ones-column count does."""
    calls["filter_agg"] += 1
    sums, counts = filter_agg(mask, gidx.to(torch.int32),
                              [v.to(torch.float32) for v in value_cols],
                              n_groups)
    return sums, counts.to(torch.float32)


def compact_query(mask, capacity, *, translate=False):
    """Single-pass drop-in for `backend.compact`: (idx, count), plus the
    key→slot translation vector when `translate`."""
    calls["compact"] += 1
    return compact(mask, int(capacity), translate=translate)


def compact_pred_query(cols, scalars, pred_fn, capacity, *, translate=False):
    """Fused filter → compact: predicate evaluated in-kernel."""
    calls["compact_pred"] += 1
    return compact_pred(cols, scalars, pred_fn, int(capacity),
                        translate=translate)


def selective_agg_query(cols, scalars, pred_fn, value_fns, gidx_fn,
                        n_groups):
    """The q6/q19-class pipeline: in-kernel predicate + grouped
    aggregation.  Returns (sums (G, A), counts (G,) float32,
    total_count)."""
    calls["selective_agg"] += 1
    sums, counts, total = selective_filter_agg(
        cols, scalars, pred_fn, value_fns, gidx_fn, n_groups)
    return sums, counts.to(torch.float32), total
