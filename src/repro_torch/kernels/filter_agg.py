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
`csrc/filter_agg.cuh` for its design) or raises.  `launches` counts
kernel launches only.
"""
from __future__ import annotations

import ctypes

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
    sums = torch.zeros((n_groups, vals.shape[1]), dtype=torch.float32,
                       device=mask.device)
    sums.index_add_(0, g, torch.where(ok[:, None], vals, 0.0))
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
_AGG_ARGS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 7


def _lib():
    if not _STATIC:
        lib = build.load("filter_agg", build.static_source("filter_agg"))
        vp = ctypes.c_void_p
        lib.repro_agg_blocks.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int]
        lib.repro_filter_agg_max_vals.argtypes = []
        lib.repro_filter_agg.argtypes = [vp, vp, vp, ctypes.c_int] + _AGG_ARGS
        for fn in (lib.repro_agg_blocks, lib.repro_filter_agg_max_vals,
                   lib.repro_filter_agg):
            fn.restype = ctypes.c_int
        _STATIC.append(lib)
    return _STATIC[0]


def _check_fits(n_groups: int, n_vals: int):
    if n_groups < 1:
        raise ValueError(f"n_groups must be positive (got {n_groups})")
    if n_groups * (n_vals + 1) * 4 > SMEM_LIMIT:
        raise ValueError(
            f"{n_groups} groups x {n_vals} values do not fit one block's "
            "shared memory")


def _outputs(lib, n: int, n_groups: int, n_vals: int, device):
    """(launch args after n: G, nb and the six buffers, the partials,
    the result tuple).  The caller holds the partials until the launch
    is queued: a freed buffer goes back to the allocator at once, and the
    next allocation on the stream may take it while the kernel has yet to
    write there."""
    nb = lib.repro_agg_blocks(n, n_groups, n_vals)
    f32, i32 = torch.float32, torch.int32
    parts = (torch.empty((nb, n_groups, n_vals), dtype=f32, device=device),
             torch.empty((nb, n_groups), dtype=i32, device=device),
             torch.empty(nb, dtype=i32, device=device))
    res = (torch.empty((n_groups, n_vals), dtype=f32, device=device),
           torch.empty(n_groups, dtype=i32, device=device),
           torch.empty((), dtype=i32, device=device))
    return [n_groups, nb] + [build.ptr(t) for t in parts + res], parts, res


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
    if len(values) > lib.repro_filter_agg_max_vals():
        raise ValueError(f"filter_agg takes at most "
                         f"{lib.repro_filter_agg_max_vals()} value columns "
                         f"(got {len(values)})")
    _check_fits(n_groups, len(values))
    args, parts, (sums, counts, _total) = _outputs(
        lib, n, n_groups, len(values), mask.device)
    ptrs = (ctypes.c_void_p * max(len(values), 1))(
        *[v.data_ptr() for v in values])
    build.check(lib.repro_filter_agg(
        build.ptr(mask), build.ptr(gidx), ptrs, len(values), n, *args,
        build.stream_ptr(mask)), "filter_agg")
    del parts          # queued: the stream orders any reuse after the kernel
    launches["filter_agg"] += 1
    return sums, counts


def selective_source(cols: dict, scalars: list, pred_fn, value_fns: list,
                     gidx_fn, n_groups: int) -> tuple[str, str]:
    """(library name, generated source) of the selective pipeline."""
    em = codegen.Emitter(codegen.column_types(cols),
                         codegen.param_types(pred_fn.param_names, scalars))
    radix = gidx_fn.radix if gidx_fn is not None else []
    return "selective_agg", codegen.selective_agg_source(
        pred_fn.expr, [f.expr for f in value_fns], radix, n_groups, em)


_GEN_LIBS: dict[str, ctypes.CDLL] = {}


def _selective_lib(cols, scalars, pred_fn, value_fns, gidx_fn, n_groups):
    name, src = selective_source(cols, scalars, pred_fn, value_fns, gidx_fn,
                                 n_groups)
    lib = _GEN_LIBS.get(src)
    if lib is None:
        lib = build.load(name, src)
        vp = ctypes.c_void_p
        lib.repro_selective_agg.argtypes = [vp, vp, vp] + _AGG_ARGS + [vp]
        lib.repro_selective_agg.restype = ctypes.c_int
        _GEN_LIBS[src] = lib
    return lib


def _selective_cuda(cols: dict, scalars: list, pred_fn, value_fns: list,
                    gidx_fn, n_groups: int, capacity: int, translate: bool):
    _check_compaction(capacity, translate)
    for name, t in cols.items():
        build.check_cuda_1d(name, t)
    n = next(iter(cols.values())).shape[0]
    if any(t.shape[0] != n for t in cols.values()):
        raise ValueError("selective_filter_agg columns differ in length")
    if gidx_fn is not None and gidx_fn.n_groups != n_groups:
        raise ValueError("group index and n_groups disagree")
    _check_fits(n_groups, len(value_fns))
    lib = _selective_lib(cols, scalars, pred_fn, value_fns, gidx_fn,
                         n_groups)
    dev = next(iter(cols.values())).device
    args, parts, res = _outputs(_lib(), n, n_groups, len(value_fns), dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev) if capacity else None
    fp, ip = codegen.split_scalars(pred_fn.param_names, scalars)
    build.check(lib.repro_selective_agg(
        (ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols.values()]),
        (ctypes.c_double * max(len(fp), 1))(*fp),
        (ctypes.c_longlong * max(len(ip), 1))(*ip),
        n, *args, build.ptr(mask),
        build.stream_ptr(next(iter(cols.values())))),
        "selective_filter_agg")
    del parts          # queued: the stream orders any reuse after the kernel
    if not capacity:
        launches["selective_filter_agg"] += 1
        return res
    idx, _count, *slot = rank_mask_cuda(mask, capacity, translate)
    launches["selective_filter_agg_capacity"] += 1
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
