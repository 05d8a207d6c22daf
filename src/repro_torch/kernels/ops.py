"""The kernel library's public surface (the reference's `kernels/ops.py`):
every entry point of `repro.kernels`, on torch tensors, plus the engine's.

Library entry points, with the reference's contracts:

  filter_agg(mask, gidx, vals (n, A), n_groups)        -> sums (G, A)
  gather_join(fk, table (K, C))                        -> (n, C)
  masked_topk(vals, mask, k)                           -> values, ids
  compact(mask, capacity, *, translate=False)          -> idx, count[, slot_of]
  compact_translate(mask, capacity)                    -> idx, count, slot_of
  compact_pred(cols, scalars, pred_fn, capacity, *, translate=False)
  selective_filter_agg(cols, scalars, pred_fn, vals_fns, gidx_fn, n_vals,
                       n_groups, capacity=0, translate=False)
                                             -> sums, count[, idx][, slot_of]

Predicates and values are `operators.fused.TileFn`s (a plan `Expr` and
its parameter names) and the group index a `fused.GroupIndex` or None,
not Python closures as in the reference: a CUDA kernel cannot call
Python, so the kernel's source is generated from the expression
(`codegen.py`), and calling a TileFn is the plain torch evaluation of
the same expression.  There is no `tile` and no `interpret` argument,
and no `resolve_interpret`: the tensors' device decides the version (CPU
tensors take the plain torch versions, CUDA tensors launch the hand
kernels or the call raises), and each kernel picks its own block shape.

The engine's entry points: `filter_agg_query` is the integration point
of scalar and dense aggregation; `compact_query`, `compact_pred_query`
and `selective_agg_query` those of `operators.compact` and the fused
selective pipeline.  `calls` counts the calls of each engine entry point
whichever version ran; the kernel modules' `launches` count CUDA
launches only.  Both count under a lock (`build.bump`): a server's pool
threads execute queries at the same time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# by name from the modules: the package exports this module's functions
# under the modules' own names (`compact`, `filter_agg`, `gather_join`)
from repro_torch.kernels.compact import compact as _compact
from repro_torch.kernels.compact import compact_pred as _compact_pred
from repro_torch.kernels.filter_agg import filter_agg as _filter_agg
from repro_torch.kernels.filter_agg import \
    selective_filter_agg as _selective_filter_agg
from repro_torch.kernels.gather_join import gather_join
from repro_torch.kernels.topk import masked_topk

__all__ = ["filter_agg", "gather_join", "masked_topk", "filter_agg_query",
           "compact", "compact_translate", "compact_pred", "compact_query",
           "compact_pred_query", "selective_filter_agg",
           "selective_agg_query", "calls"]

calls = {"filter_agg": 0, "compact": 0, "compact_pred": 0,
         "selective_agg": 0}


# ---------------------------------------------------------------------------
# the library surface
# ---------------------------------------------------------------------------

def filter_agg(mask, gidx, vals, n_groups):
    """Sum of `vals[i, a]` into group `gidx[i]` where `mask[i]`: `(G, A)`
    float32; rows whose group is outside `[0, G)` add to no group.  A NaN
    or infinity in a row the mask drops reaches no sum, and one in a kept
    row only its own group's (the oracle's `where`; the reference's
    Pallas kernel spreads it to every group)."""
    cols = list(vals.to(torch.float32).t().contiguous())
    sums, _counts = _filter_agg(mask, gidx.to(torch.int32), cols,
                                int(n_groups))
    return sums


def compact(mask, capacity, *, translate=False):
    """`(idx int32[capacity], count)`, plus `slot_of int32[n]` when
    `translate`: the valid row ids in order, pad slots 0, count exact."""
    return _compact(mask, int(capacity), translate=translate)


def compact_translate(mask, capacity):
    """`compact` with the key->slot translation vector."""
    return _compact(mask, int(capacity), translate=True)


def compact_pred(cols, scalars, pred_fn, capacity, *, translate=False):
    """Filter -> compact with the predicate evaluated in-kernel."""
    return _compact_pred(cols, scalars, pred_fn, int(capacity),
                         translate=translate)


def selective_filter_agg(cols, scalars, pred_fn, vals_fns, gidx_fn, n_vals,
                         n_groups, capacity=0, translate=False):
    """The selective pipeline: `(sums (G, n_vals), count[, idx][,
    slot_of])`, where `count` is the exact number of predicate-true rows
    (above `capacity` it signals overflow), `idx` their compacted ids
    when `capacity > 0` and `slot_of` their key->slot vector when
    `translate` (which needs a capacity)."""
    vals_fns = list(vals_fns)
    if len(vals_fns) != n_vals:
        raise ValueError(f"{len(vals_fns)} value functions for n_vals "
                         f"{n_vals}")
    sums, _counts, total, *rest = _selective_filter_agg(
        cols, scalars, pred_fn, vals_fns, gidx_fn, int(n_groups),
        capacity=int(capacity), translate=translate)
    return (sums, total, *rest)


# ---------------------------------------------------------------------------
# the engine's entry points
# ---------------------------------------------------------------------------

def filter_agg_query(mask, gidx, value_cols, n_groups):
    """Aggregate a list of 1-D value columns and count the rows per group
    in one kernel pass.  Returns (sums (G, A) float32, counts (G,) int32):
    the count is exact, where the reference's float32 ones-column count
    is exact only up to 2^24 rows per group."""
    build.bump(calls, "filter_agg")
    return _filter_agg(mask, gidx.to(torch.int32),
                       [v.to(torch.float32) for v in value_cols], n_groups)


def compact_query(mask, capacity, *, translate=False):
    """Single-pass drop-in for `backend.compact`: (idx, count), plus the
    key→slot translation vector when `translate`."""
    build.bump(calls, "compact")
    return _compact(mask, int(capacity), translate=translate)


def compact_pred_query(cols, scalars, pred_fn, capacity, *, translate=False):
    """Fused filter → compact: predicate evaluated in-kernel."""
    build.bump(calls, "compact_pred")
    return _compact_pred(cols, scalars, pred_fn, int(capacity),
                         translate=translate)


def selective_agg_query(cols, scalars, pred_fn, value_fns, gidx_fn,
                        n_groups):
    """The q6/q19-class pipeline: in-kernel predicate + grouped
    aggregation.  Returns (sums (G, A) float32, counts (G,) int32,
    total_count int32), every count exact."""
    build.bump(calls, "selective_agg")
    return _selective_filter_agg(cols, scalars, pred_fn, value_fns, gidx_fn,
                                 n_groups)
