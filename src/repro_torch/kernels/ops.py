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
of scalar and dense aggregation, `dense_agg_query` that of dense
aggregation past `filter_agg`'s domains (`dense_agg.py`);
`compact_query`, `compact_pred_query` and `selective_agg_query` those
of `operators.compact` and the fused selective pipeline.  `calls`
counts the calls of each engine entry point whichever version ran; the
kernel modules' `launches` count CUDA launches only.  Both count under
a lock (`build.bump`): a server's pool threads execute queries at the
same time.

Each engine entry point calls one `torch.library.custom_op` of the
`repro_torch` namespace (`torch.ops.repro_torch.<entry>`), so that the engine's bind-many pass
(`CompiledQuery.run_many`: the staged walk under `torch.func.vmap`) can
carry it: the op's implementation packs the scalar call's outputs (the
kernel's launch on CUDA tensors, the plain version on CPU ones), and its
vmap rule is the batched call (`compact_batched`, `compact_pred_batched`,
`filter_agg_batched`, `selective_filter_agg_batched`,
`dense_agg_batched_packed`: one launch for B bindings on the card, with
each operand's binding stride 0 where vmap left it unbatched; the
batched plain version on the CPU).  A call with no batched operand (the
scalar walk, or a call under vmap whose operands do not depend on the
bindings) is the scalar call once, made
by the entry point itself (`_batched`), its result shared by every
binding, so the op itself runs only under vmap on the engine's path.
An op returns one packed tensor (its outputs may not alias each other),
which the entry point splits into views.  The
generated kernels' functions (a `fused.TileFn` is no operator argument)
reach the op as a handle into `FUNCTIONS`, the parameters as the
float64 and int64 vectors and kinds of `compact.param_vectors`.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build, codegen
from repro_torch.kernels import compact as _kc
from repro_torch.kernels import dense_agg as _kd
from repro_torch.kernels import filter_agg as _kf

# by name from the modules: the package exports this module's functions
# under the modules' own names (`compact`, `filter_agg`, `gather_join`)
from repro_torch.kernels.compact import compact as _compact
from repro_torch.kernels.compact import compact_pred as _compact_pred
from repro_torch.kernels.dense_agg import dense_agg as _dense_agg
from repro_torch.kernels.filter_agg import filter_agg as _filter_agg
from repro_torch.kernels.filter_agg import \
    selective_filter_agg as _selective_filter_agg
from repro_torch.kernels.gather_join import gather_join
from repro_torch.kernels.topk import masked_topk

__all__ = ["filter_agg", "gather_join", "masked_topk", "filter_agg_query",
           "compact", "compact_translate", "compact_pred", "compact_query",
           "compact_pred_query", "selective_filter_agg",
           "selective_agg_query", "dense_agg_query", "calls"]

calls = {"filter_agg": 0, "compact": 0, "compact_pred": 0,
         "selective_agg": 0, "dense_agg": 0}


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
# the engine's custom operators
# ---------------------------------------------------------------------------

# the generated kernels' functions: handle -> (column names, pred_fn,
# value_fns, gidx_fn), one handle a distinct (columns, expressions,
# parameter names, group index)
FUNCTIONS: list = []
_FUNCTION_IDS: dict = {}
_FUNCTION_LOCK = threading.Lock()


def _handle(names, pred_fn, value_fns=(), gidx_fn=None,
            n_groups: int = 1) -> int:
    key = (tuple(names), codegen.expr_key(pred_fn.expr),
           tuple(pred_fn.param_names),
           tuple(codegen.expr_key(f.expr) for f in value_fns),
           tuple(gidx_fn.radix) if gidx_fn is not None else (), n_groups)
    with _FUNCTION_LOCK:
        h = _FUNCTION_IDS.get(key)
        if h is None:
            h = _FUNCTION_IDS[key] = len(FUNCTIONS)
            FUNCTIONS.append((tuple(names), pred_fn, list(value_fns),
                              gidx_fn))
        return h


def _kinds(kinds: str) -> tuple:
    return tuple(kinds.split(",")) if kinds else ()


def _lead(t, d):
    """An operand of a vmap rule with its batch dimension in front (or
    as it is, shared by every binding)."""
    return t if d is None else t.movedim(d, 0)


@torch.library.custom_op("repro_torch::compact", mutates_args=())
def _compact_op(mask: torch.Tensor, capacity: int,
                translate: bool) -> torch.Tensor:
    return _kc.pack(_compact(mask, capacity, translate=translate))


@_compact_op.register_vmap
def _compact_vmap(info, in_dims, mask, capacity, translate):
    return _kc.compact_batched_packed(_lead(mask, in_dims[0]), capacity,
                                      translate), 0


@torch.library.custom_op("repro_torch::compact_pred", mutates_args=())
def _compact_pred_op(fn: int, cols: list[torch.Tensor], fp: torch.Tensor,
                     ip: torch.Tensor, kinds: str, capacity: int,
                     translate: bool) -> torch.Tensor:
    names, pred_fn, _v, _g = FUNCTIONS[fn]
    return _kc.pack(_compact_pred(
        dict(zip(names, cols)), _kc.binding_scalars(fp, ip, _kinds(kinds), 0),
        pred_fn, capacity, translate=translate))


@_compact_pred_op.register_vmap
def _compact_pred_vmap(info, in_dims, fn, cols, fp, ip, kinds, capacity,
                       translate):
    names, pred_fn, _v, _g = FUNCTIONS[fn]
    cols = [_lead(c, d) for c, d in zip(cols, in_dims[1])]
    return _kc.compact_pred_batched_packed(
        dict(zip(names, cols)), _lead(fp, in_dims[2]), _lead(ip, in_dims[3]),
        _kinds(kinds), pred_fn, capacity, translate), 0


@torch.library.custom_op("repro_torch::filter_agg", mutates_args=())
def _filter_agg_op(mask: torch.Tensor, gidx: torch.Tensor,
                   values: list[torch.Tensor], n_groups: int) -> torch.Tensor:
    sums, counts = _filter_agg(mask, gidx, values, n_groups)
    return _kf.agg_pack(sums, counts, mask.sum(dtype=torch.int32))


@_filter_agg_op.register_vmap
def _filter_agg_vmap(info, in_dims, mask, gidx, values, n_groups):
    return _kf.filter_agg_batched_packed(
        _lead(mask, in_dims[0]), _lead(gidx, in_dims[1]),
        [_lead(v, d) for v, d in zip(values, in_dims[2])], n_groups), 0


@torch.library.custom_op("repro_torch::selective_agg", mutates_args=())
def _selective_agg_op(fn: int, cols: list[torch.Tensor], fp: torch.Tensor,
                      ip: torch.Tensor, kinds: str,
                      n_groups: int) -> torch.Tensor:
    names, pred_fn, value_fns, gidx_fn = FUNCTIONS[fn]
    return _kf.agg_pack(*_selective_filter_agg(
        dict(zip(names, cols)), _kc.binding_scalars(fp, ip, _kinds(kinds), 0),
        pred_fn, value_fns, gidx_fn, n_groups))


@_selective_agg_op.register_vmap
def _selective_agg_vmap(info, in_dims, fn, cols, fp, ip, kinds, n_groups):
    names, pred_fn, value_fns, gidx_fn = FUNCTIONS[fn]
    cols = [_lead(c, d) for c, d in zip(cols, in_dims[1])]
    return _kf.selective_filter_agg_batched_packed(
        dict(zip(names, cols)), _lead(fp, in_dims[2]), _lead(ip, in_dims[3]),
        _kinds(kinds), pred_fn, value_fns, gidx_fn, n_groups), 0


@torch.library.custom_op("repro_torch::dense_agg", mutates_args=())
def _dense_agg_op(mask: torch.Tensor, gidx: torch.Tensor,
                  values: list[torch.Tensor], carries: list[torch.Tensor],
                  n_groups: int) -> torch.Tensor:
    return _kd.pack(*_dense_agg(mask, gidx, values, carries, n_groups))


@_dense_agg_op.register_vmap
def _dense_agg_vmap(info, in_dims, mask, gidx, values, carries, n_groups):
    return _kd.dense_agg_batched_packed(
        _lead(mask, in_dims[0]), _lead(gidx, in_dims[1]),
        [_lead(v, d) for v, d in zip(values, in_dims[2])],
        [_lead(c, d) for c, d in zip(carries, in_dims[3])], n_groups), 0


# ---------------------------------------------------------------------------
# the engine's entry points
# ---------------------------------------------------------------------------

def _batched(*xs) -> bool:
    """Does vmap batch any of these operands?  Only then does the call
    go through the custom operator (its vmap rule); otherwise the op's
    dispatch would run the same scalar call, at a measured 0.05 to 0.3 ms
    more host time a call (`benchmarks/bench_torch_host.py`, PERF.md), so
    the entry point makes that call itself."""
    return any(isinstance(x, torch.Tensor) and _is_batched(x) for x in xs)


_is_batched = torch._C._functorch.is_batchedtensor


def filter_agg_query(mask, gidx, value_cols, n_groups):
    """Aggregate a list of 1-D value columns and count the rows per group
    in one kernel pass.  Returns (sums (G, A) float32, counts (G,) int32):
    the count is exact, where the reference's float32 ones-column count
    is exact only up to 2^24 rows per group."""
    build.bump(calls, "filter_agg")
    gidx = gidx.to(torch.int32)
    vals = [v.to(torch.float32) for v in value_cols]
    if not _batched(mask, gidx, *vals):
        return _filter_agg(mask, gidx, vals, n_groups)
    row = _filter_agg_op(mask, gidx, vals, int(n_groups))
    return _kf.agg_unpack(row, int(n_groups), len(vals))[:2]


def compact_query(mask, capacity, *, translate=False):
    """Single-pass drop-in for `backend.compact`: (idx, count), plus the
    key→slot translation vector when `translate`."""
    build.bump(calls, "compact")
    if not _batched(mask):
        return _compact(mask, int(capacity), translate=translate)
    return _kc.unpack(_compact_op(mask, int(capacity), bool(translate)),
                      int(capacity), translate)


def compact_pred_query(cols, scalars, pred_fn, capacity, *, translate=False):
    """Fused filter → compact: predicate evaluated in-kernel."""
    build.bump(calls, "compact_pred")
    if not _batched(*cols.values(), *scalars):
        return _compact_pred(cols, scalars, pred_fn, int(capacity),
                             translate=translate)
    fn = _handle(cols, pred_fn)
    fp, ip, kinds = _kc.param_vectors(scalars)
    return _kc.unpack(_compact_pred_op(fn, list(cols.values()), fp, ip,
                                       ",".join(kinds), int(capacity),
                                       bool(translate)),
                      int(capacity), translate)


def selective_agg_query(cols, scalars, pred_fn, value_fns, gidx_fn,
                        n_groups):
    """The q6/q19-class pipeline: in-kernel predicate + grouped
    aggregation.  Returns (sums (G, A) float32, counts (G,) int32,
    total_count int32), every count exact."""
    build.bump(calls, "selective_agg")
    if not _batched(*cols.values(), *scalars):
        return _selective_filter_agg(cols, scalars, pred_fn, value_fns,
                                     gidx_fn, n_groups)
    fn = _handle(cols, pred_fn, value_fns, gidx_fn, int(n_groups))
    fp, ip, kinds = _kc.param_vectors(scalars)
    row = _selective_agg_op(fn, list(cols.values()), fp, ip,
                            ",".join(kinds), int(n_groups))
    return _kf.agg_unpack(row, int(n_groups), len(value_fns))


def dense_agg_query(mask, gidx, value_cols, carry_cols, n_groups):
    """Dense aggregation over a large key domain in one kernel pass: the
    float32 sums of 1-D float32 value columns, the row counts and the
    max of 1-D int32 or float32 carry columns per group.  Returns (sums
    [(G,)], counts (G,) int32, carried [(G,)]), every count exact.
    Unlike the other entry points the engine calls it directly, not
    through `StageCtx.kernel`: it takes no runtime parameter, so a
    captured walk replays its launches inside the segment
    (`core/graphs.py`) and calls it only while capturing."""
    build.bump(calls, "dense_agg")
    gidx = gidx.to(torch.int32)
    if not _batched(mask, gidx, *value_cols, *carry_cols):
        return _dense_agg(mask, gidx, value_cols, carry_cols, n_groups)
    row = _dense_agg_op(mask, gidx, list(value_cols), list(carry_cols),
                        int(n_groups))
    return _kd.unpack(row, int(n_groups), len(value_cols),
                      _kd.kinds(carry_cols))
