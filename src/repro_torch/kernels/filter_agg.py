"""Masked grouped aggregation: the CUDA kernels and, beside them, their
plain torch versions.

  filter_agg           — sums of float32 value columns and row counts per
                         group over the rows where `mask` holds, by a
                         precomputed int32 group index;
  selective_filter_agg — the same with the predicate, the values and the
                         dense mixed-radix group index evaluated inside the
                         kernel from named columns (the q6/q19-class
                         pipeline: no mask is ever materialized).

Both return `(sums float32[G, A], counts int32[G])`; the selective form
adds the exact number of predicate-true rows.  Rows whose group index is
outside `[0, G)` count in that total but in no group.  A value in a row
the mask (or predicate) drops, or in another group, never reaches a
group's sum, and a kept NaN or infinity reaches its own group's sum
only: the reference oracle's `where` (`ref.filter_agg_ref`), not its
Pallas kernel's one-hot product, which spreads them to every group.
Given a compaction `capacity > 0`, the selective form also returns the
predicate-true row ids under the `compact` contract (`compact.py`), and
with `translate` the key->slot vector: the aggregation stores its
predicate as one byte per row and the one-launch compaction ranks it.

Which version runs is decided by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (see
`csrc/filter_agg.cuh` for its design) or raises.  A CUDA call is one
launch for each chunk of the value columns (`value_chunks`: at most 16
columns a launch, fewer where G x (A + 1) words would not fit one
block's shared memory), so every shape the engine's gate admits runs.
`launches` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, codegen
from repro_torch.kernels.compact import compact_plain, rank_mask_cuda

launches = {"filter_agg": 0, "selective_filter_agg": 0,
            "selective_filter_agg_capacity": 0}

# one block holds G x (A + 1) 4-byte accumulators in shared memory; the
# card's per-block opt-in limit is 227 KB, less the kernel's own scratch
SMEM_LIMIT = 227 * 1024 - 1024


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def filter_agg_plain(mask, gidx, values: list, n_groups: int):
    ok = mask & (gidx >= 0) & (gidx < n_groups)
    g = gidx.clamp(0, n_groups - 1)
    n = mask.shape[0]
    vals = torch.stack(list(values), 1) if values else \
        torch.zeros((n, 0), dtype=torch.float32, device=mask.device)
    # summed in float64, rounded once: a float32 index_add_ adds row by
    # row into one running sum a group, which on a card loses up to 1.5e-3
    # of a sum of 500,000 small values (q1's discounts on one shard of
    # SF 1), more than the kernels' tolerance against this version
    sums = torch.zeros((n_groups, vals.shape[1]), dtype=torch.float64,
                       device=mask.device)
    sums.index_add_(0, g, torch.where(ok[:, None], vals.double(), 0.0))
    sums = sums.to(torch.float32)
    counts = torch.zeros(n_groups, dtype=torch.int32, device=mask.device)
    counts.index_add_(0, g, ok.to(torch.int32))
    return sums, counts


def _column(v, n: int, dtype, device):
    """A tile function's result as a length-n column (a constant
    expression evaluates to a Python scalar)."""
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(v, device=device)
    return v.to(dtype).expand(n)


def _check_compaction(capacity: int, translate: bool):
    if not 0 <= capacity < 2**31:
        raise ValueError(f"capacity {capacity} out of range")
    if translate and capacity == 0:
        raise ValueError("translate requires a compaction capacity")


def selective_filter_agg_plain(cols: dict, scalars: list, pred_fn,
                               value_fns: list, gidx_fn, n_groups: int,
                               capacity: int = 0, translate: bool = False):
    _check_compaction(capacity, translate)
    first = next(iter(cols.values()))
    n, dev = first.shape[0], first.device
    m = _column(pred_fn(cols, scalars), n, torch.bool, dev)
    vals = [_column(f(cols, scalars), n, torch.float32, dev)
            for f in value_fns]
    g = torch.zeros(n, dtype=torch.int32, device=dev) if gidx_fn is None \
        else _column(gidx_fn(cols, scalars), n, torch.int32, dev)
    sums, counts = filter_agg_plain(m, g, vals, n_groups)
    out = (sums, counts, m.sum(dtype=torch.int32))
    if capacity > 0:
        idx, _count, *slot = compact_plain(m, capacity, translate)
        out += (idx, *slot)
    return out


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_STATIC: list = []
MAX_VALS = 16           # csrc/filter_agg.cu: kMaxVals


def _lib():
    if not _STATIC:
        lib = build.load("filter_agg", build.static_source("filter_agg"))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_agg_blocks.argtypes = [ll, i, i]
        lib.repro_filter_agg_max_vals.argtypes = []
        lib.repro_filter_agg.argtypes = [vp, vp, vp, i, ll, i, i, vp, vp, vp,
                                         vp]
        for fn in (lib.repro_agg_blocks, lib.repro_filter_agg_max_vals,
                   lib.repro_filter_agg):
            fn.restype = ctypes.c_int
        if lib.repro_filter_agg_max_vals() != MAX_VALS:
            raise RuntimeError("filter_agg.cu and filter_agg.py disagree on "
                               "the value columns a launch takes")
        _STATIC.append(lib)
    return _STATIC[0]


def _check_fits(n_groups: int, n_vals: int):
    if n_groups < 1:
        raise ValueError(f"n_groups must be positive (got {n_groups})")
    if n_groups * (n_vals + 1) * 4 > SMEM_LIMIT:
        raise ValueError(
            f"{n_groups} groups x {n_vals} values do not fit one block's "
            "shared memory")


def value_chunks(n_groups: int, n_vals: int) -> list[tuple[int, int]]:
    """`[start, stop)` ranges of the value columns, in order, one per
    launch: each holds at most `MAX_VALS` columns and fits G x (a + 1)
    4-byte accumulators in one block's shared memory (at least 13 columns
    a launch for G <= 4096).  No value column is one launch of none.
    Raises where even one column does not fit beside G's counts."""
    _check_fits(n_groups, min(n_vals, 1))
    if n_vals == 0:
        return [(0, 0)]
    width = min(MAX_VALS, SMEM_LIMIT // (4 * n_groups) - 1)
    return [(s, min(s + width, n_vals)) for s in range(0, n_vals, width)]


@functools.lru_cache(maxsize=1024)
def _agg_blocks(n: int, n_groups: int, n_vals: int) -> int:
    return _lib().repro_agg_blocks(n, n_groups, n_vals)


_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(device, stream) -> torch.Tensor:
    """The fold's ticket for (device, stream): one int32, zeroed once when
    it is made and never freed (`csrc/filter_agg.cuh`: launches on one
    stream run one after another and each leaves it at 0)."""
    key = (device.index, stream.value)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


# partial words a result may keep alive: a call's partials at most this
# large share one allocation with its result (every register-regime call:
# at most 1,024 rows of 76 words), larger ones are freed once the launch
# is queued
SHARED_ALLOC_WORDS = 1 << 17


def _outputs(n: int, n_groups: int, n_vals: int, device):
    """(nb, partials, result pointer, result): nb rows of G x A + G + 1
    int32 words padded to a multiple of 4 (`csrc/filter_agg.cuh`), and
    one more such row for the result, whose `(sums, counts, total)` are
    views.  Small partials and the result are one allocation, the result
    its last row, so the result keeps them alive; larger partials are an
    allocation of their own, which the caller holds until the launch has
    been queued."""
    nb = _agg_blocks(n, n_groups, n_vals)
    ga = n_groups * n_vals
    row = (ga + n_groups + 1 + 3) // 4 * 4
    part = nb * row
    if part <= SHARED_ALLOC_WORDS:
        ws = res = torch.empty(part + row, dtype=torch.int32, device=device)
        at = part
    else:
        ws = torch.empty(part, dtype=torch.int32, device=device)
        res = torch.empty(row, dtype=torch.int32, device=device)
        at = 0
    return nb, ws, res.data_ptr() + 4 * at, (   # as_strided: one view op each
        res.view(torch.float32).as_strided((n_groups, n_vals), (n_vals, 1),
                                           at),
        res.as_strided((n_groups,), (1,), at + ga),
        res.as_strided((), (), at + ga + n_groups))


def _cat_sums(results: list):
    """One call's result from its launches: the sums side by side, the
    counts and the total from the first launch."""
    if len(results) == 1:
        return results[0]
    return (torch.cat([r[0] for r in results], 1), *results[0][1:])


def _filter_agg_cuda(mask, gidx, values: list, n_groups: int):
    build.check_cuda_1d("mask", mask, torch.bool)
    build.check_cuda_1d("gidx", gidx, torch.int32)
    n = mask.shape[0]
    for k, v in enumerate(values):
        build.check_cuda_1d(f"values[{k}]", v, torch.float32)
        if v.shape[0] != n:
            raise ValueError("filter_agg columns differ in length")
    if gidx.shape[0] != n:
        raise ValueError("filter_agg columns differ in length")
    lib = _lib()
    stream = build.stream_ptr(mask)
    ticket = _ticket(mask.device, stream)
    results = []
    for start, stop in value_chunks(n_groups, len(values)):
        chunk = values[start:stop]
        nb, ws, out, res = _outputs(n, n_groups, len(chunk), mask.device)
        ptrs = (ctypes.c_void_p * max(len(chunk), 1))(
            *[v.data_ptr() for v in chunk])
        build.check(lib.repro_filter_agg(
            build.ptr(mask), build.ptr(gidx), ptrs, len(chunk), n, n_groups,
            nb, build.ptr(ws), out, build.ptr(ticket), stream), "filter_agg")
        build.bump(launches, "filter_agg")
        results.append(res)
    sums, counts, _total = _cat_sums(results)
    return sums, counts


def selective_source(cols: dict, scalars: list, pred_fn, value_fns: list,
                     gidx_fn, n_groups: int) -> tuple[str, str]:
    """(library name, generated source) of the selective pipeline."""
    em = codegen.emitter(cols, pred_fn.param_names, scalars)
    radix = gidx_fn.radix if gidx_fn is not None else []
    return "selective_agg", codegen.selective_agg_source(
        pred_fn.expr, [f.expr for f in value_fns], radix, n_groups, em)


def selective_key(cols: dict, scalars: list, pred_fn, value_fns: list,
                  gidx_fn, n_groups: int) -> tuple:
    """The generated library's key: everything its source depends on,
    cheaper to make than the source."""
    return (codegen.expr_key(pred_fn.expr),
            tuple(codegen.expr_key(f.expr) for f in value_fns),
            tuple(gidx_fn.radix) if gidx_fn is not None else (), n_groups,
            codegen.operand_key(cols, pred_fn.param_names, scalars))


_GEN_LIBS: dict[tuple, ctypes.CDLL] = {}


def _selective_lib(cols, scalars, pred_fn, value_fns, gidx_fn, n_groups):
    key = selective_key(cols, scalars, pred_fn, value_fns, gidx_fn, n_groups)
    lib = _GEN_LIBS.get(key)
    if lib is None:
        lib = build.load(*selective_source(cols, scalars, pred_fn, value_fns,
                                           gidx_fn, n_groups))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_selective_agg.argtypes = [vp, vp, vp, ll, i, i, vp, vp, vp,
                                            vp, vp]
        lib.repro_selective_agg.restype = ctypes.c_int
        _GEN_LIBS[key] = lib
    return lib


def _selective_cuda(cols: dict, scalars: list, pred_fn, value_fns: list,
                    gidx_fn, n_groups: int, capacity: int, translate: bool):
    _check_compaction(capacity, translate)
    for name, t in cols.items():
        build.check_cuda_column(name, t)
    first = next(iter(cols.values()))
    n = first.shape[0]
    if any(t.shape[0] != n for t in cols.values()):
        raise ValueError("selective_filter_agg columns differ in length")
    if gidx_fn is not None and gidx_fn.n_groups != n_groups:
        raise ValueError("group index and n_groups disagree")
    chunks = value_chunks(n_groups, len(value_fns))
    dev = first.device
    stream = build.stream_ptr(first)
    ticket = _ticket(dev, stream)
    col_ptrs = (ctypes.c_void_p * len(cols))(
        *[t.data_ptr() for t in cols.values()])
    fp, ip = codegen.split_scalars(pred_fn.param_names, scalars)
    fp = (ctypes.c_double * max(len(fp), 1))(*fp)
    ip = (ctypes.c_longlong * max(len(ip), 1))(*ip)
    mask = torch.empty(n, dtype=torch.bool, device=dev) if capacity else None
    results = []
    for k, (start, stop) in enumerate(chunks):
        fns = value_fns[start:stop]
        lib = _selective_lib(cols, scalars, pred_fn, fns, gidx_fn, n_groups)
        nb, ws, out, res = _outputs(n, n_groups, len(fns), dev)
        build.check(lib.repro_selective_agg(
            col_ptrs, fp, ip, n, n_groups, nb, build.ptr(ws), out,
            build.ptr(ticket), build.ptr(mask if k == 0 else None), stream),
            "selective_filter_agg")
        results.append(res)
    res = _cat_sums(results)
    if not capacity:
        build.bump(launches, "selective_filter_agg", len(chunks))
        return res
    idx, _count, *slot = rank_mask_cuda(mask, capacity, translate)
    build.bump(launches, "selective_filter_agg_capacity", len(chunks))
    return res + (idx, *slot)


# ---------------------------------------------------------------------------
# entry points: the version follows the tensors' device
# ---------------------------------------------------------------------------

def filter_agg(mask, gidx, values: list, n_groups: int):
    """`(sums (G, A), counts (G,))` of float32 columns `values` over the
    rows where `mask` holds, grouped by `gidx`."""
    if mask.device.type == "cpu":
        return filter_agg_plain(mask, gidx, values, n_groups)
    return _filter_agg_cuda(mask, gidx, list(values), int(n_groups))


def selective_filter_agg(cols: dict, scalars: list, pred_fn, value_fns: list,
                         gidx_fn, n_groups: int, *, capacity: int = 0,
                         translate: bool = False):
    """`(sums (G, A), counts (G,), total[, idx][, slot_of])` with the
    predicate (`pred_fn`), the values (`value_fns`, `fused.TileFn`s) and
    the group index (`gidx_fn`, a `fused.GroupIndex`, or None for one
    group) evaluated in-kernel.  Every TileFn shares one positional
    parameter list.  `capacity > 0` adds the compacted ids of the
    predicate-true rows, `translate` their key->slot vector."""
    if next(iter(cols.values())).device.type == "cpu":
        return selective_filter_agg_plain(cols, scalars, pred_fn, value_fns,
                                          gidx_fn, n_groups, capacity,
                                          translate)
    return _selective_cuda(cols, scalars, pred_fn, list(value_fns), gidx_fn,
                           int(n_groups), int(capacity), translate)
