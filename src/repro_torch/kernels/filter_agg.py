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

The batched forms (`filter_agg_batched`, `selective_filter_agg_batched`
at capacity 0: the engine's bind-many pass) take B bindings at once,
each operand either shared by every binding (one binding's shape) or
batched (B in front), and return every output with B in front: slot b is
the scalar form's output on binding b's operands, in the register regime
bit for bit (`csrc/filter_agg.cuh`'s binding axis).  On the card they
are one launch for B bindings a chunk of value columns; their plain
versions loop over the bindings through the scalar plain versions.

Each batched form also has a packed output (`*_batched_packed`), the
one tensor the engine's custom operators return (`ops.py`): the
kernel's result row `[G x A float32 sums as int32 words][G counts]
[total]` a binding, which `agg_unpack` splits; `agg_pack` makes it from
the scalar form's outputs.

Which version runs is decided by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (see
`csrc/filter_agg.cuh` for its design) or raises.  A CUDA call is one
launch for each chunk of the value columns (`value_chunks`: at most 16
columns a launch, fewer where G x (A + 1) words would not fit one
block's shared memory), so every shape the engine's gate admits runs.
`launches` counts kernel launches only, a batched launch once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, codegen
from repro_torch.kernels.compact import (_batch_rows, _check_batch,
                                         batch_operands, batch_size, binding,
                                         binding_scalars, compact_plain,
                                         rank_mask_cuda)

launches = {"filter_agg": 0, "selective_filter_agg": 0,
            "selective_filter_agg_capacity": 0, "filter_agg_batched": 0,
            "selective_filter_agg_batched": 0}

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


def agg_pack(sums, counts, total):
    """`(sums (G, A), counts (G,), total)` (B in front where they have
    it) as the packed row."""
    lead = counts.shape[:-1]
    return torch.cat([sums.reshape(*lead, -1).view(torch.int32), counts,
                      total.reshape(*lead, 1).to(torch.int32)], -1)


def _as_float32(t):
    """`t`'s int32 words as float32: a dtype view, taken under vmap on the
    tensor vmap wraps (torch 2.11's vmap has no batching rule for a dtype
    view, and its fallback takes no view op)."""
    from torch._C import _functorch as F

    if not F.is_batchedtensor(t):
        return t.view(torch.float32)
    return F._add_batch_dim(_as_float32(F.get_unwrapped(t)),
                            F.maybe_get_bdim(t), F.maybe_get_level(t))


def agg_unpack(row, n_groups: int, n_vals: int):
    """The packed row (B in front or not, padded or not) as `(sums,
    counts, total)`, views of it."""
    ga = n_groups * n_vals
    return (_as_float32(row[..., :ga]).unflatten(-1, (n_groups, n_vals)),
            row[..., ga:ga + n_groups], row[..., ga + n_groups])


def filter_agg_batched_plain(mask, gidx, values: list, n_groups: int):
    """B bindings of `filter_agg_plain`: each operand (n,) shared or (B,
    n); `(sums (B, G, A), counts (B, G))`."""
    B = batch_size((mask, 1), (gidx, 1), *[(v, 1) for v in values])
    return tuple(torch.stack(o) for o in zip(*[
        filter_agg_plain(binding(mask, b, 1), binding(gidx, b, 1),
                         [binding(v, b, 1) for v in values], n_groups)
        for b in range(B)]))


def selective_filter_agg_batched_plain(cols: dict, fp, ip, kinds, pred_fn,
                                       value_fns: list, gidx_fn,
                                       n_groups: int):
    """B bindings of `selective_filter_agg_plain` at capacity 0 (the
    parameters as `compact.param_vectors` gives them): `(sums (B, G, A),
    counts (B, G), total (B,))`."""
    B = batch_size(*[(t, 1) for t in cols.values()], (fp, 1), (ip, 1))
    return tuple(torch.stack(o) for o in zip(*[
        selective_filter_agg_plain(
            {k: binding(t, b, 1) for k, t in cols.items()},
            binding_scalars(fp, ip, kinds, b), pred_fn, value_fns, gidx_fn,
            n_groups) for b in range(B)]))


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
        lib.repro_filter_agg_batched.argtypes = [
            vp, ll, vp, ll, vp, vp, i, i, ll, i, i, vp, vp, ll, vp, vp]
        for fn in (lib.repro_agg_blocks, lib.repro_filter_agg_max_vals,
                   lib.repro_filter_agg, lib.repro_filter_agg_batched):
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


def _ticket(device, stream, B: int = 1) -> torch.Tensor:
    """The fold's tickets for (device, stream), at least B int32 (one a
    binding), zeroed when they are made and never freed
    (`csrc/filter_agg.cuh`: launches on one stream run one after another
    and each leaves its tickets at 0).  A call for more bindings than
    the stream has tickets makes a larger set; the old one goes back to
    the stream's allocator once the launches queued before are done."""
    key = (device.index, stream.value)
    t = _TICKETS.get(key)
    if t is None or t.shape[0] < B:
        t = _TICKETS[key] = torch.zeros(max(B, 1), dtype=torch.int32,
                                        device=device)
    return t


# partial words a result may keep alive: a call's partials at most this
# large share one allocation with its result (every register-regime call:
# at most 1,024 rows of 76 words), larger ones are freed once the launch
# is queued
SHARED_ALLOC_WORDS = 1 << 17


def _result_rows(n: int, n_groups: int, n_vals: int, B: int, device):
    """(nb, partials, results (B, row)): B x nb rows of G x A + G + 1
    int32 words padded to a multiple of 4 (`csrc/filter_agg.cuh`), and
    B more such rows for the results.  Small partials and the results are
    one allocation, the results its last B rows, so a result keeps them
    alive; larger partials are an allocation of their own, which the
    caller holds until the launch has been queued."""
    nb = _agg_blocks(n, n_groups, n_vals)
    row = (n_groups * n_vals + n_groups + 1 + 3) // 4 * 4
    part = B * nb * row
    if part <= SHARED_ALLOC_WORDS:
        ws = torch.empty(part + B * row, dtype=torch.int32, device=device)
        res = ws[part:]
    else:
        ws = torch.empty(part, dtype=torch.int32, device=device)
        res = torch.empty(B * row, dtype=torch.int32, device=device)
    return nb, ws, res.view(B, row)


def _outputs(n: int, n_groups: int, n_vals: int, device):
    """(nb, partials, result pointer, result) of a scalar launch: its
    one result row, whose `(sums, counts, total)` are views."""
    nb, ws, res = _result_rows(n, n_groups, n_vals, 1, device)
    ga, at = n_groups * n_vals, res.storage_offset()
    return nb, ws, res.data_ptr(), (   # as_strided: one view op each
        res.view(torch.float32).as_strided((n_groups, n_vals), (n_vals, 1)),
        res.as_strided((n_groups,), (1,), at + ga),
        res.as_strided((), (), at + ga + n_groups))


def _batched_result(rows: list, results: list):
    """A batched call's packed result from its launches' result rows (B,
    row) and their views: the row itself for one launch, else the sums
    side by side."""
    if len(rows) == 1:
        return rows[0]
    return agg_pack(*_cat_sums(results))


def _cat_sums(results: list):
    """One call's result from its launches: the sums side by side, the
    counts and the total from the first launch."""
    if len(results) == 1:
        return results[0]
    return (torch.cat([r[0] for r in results], -1), *results[0][1:])


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


def _operand(t, what: str, dtype):
    """A CUDA operand of a batched launch, shared (n,) or batched (B, n),
    and its binding stride in elements (0: shared)."""
    if t.ndim == 1:
        build.check_cuda_1d(what, t, dtype)
        return t, 0
    return _batch_rows(t, what, dtype)


def _filter_agg_batched_cuda(mask, gidx, values: list, n_groups: int):
    B = batch_size((mask, 1), (gidx, 1), *[(v, 1) for v in values])
    _check_batch(B)
    mask, ms = _operand(mask, "mask", torch.bool)
    gidx, gs = _operand(gidx, "gidx", torch.int32)
    vals = [_operand(v, f"values[{k}]", torch.float32)
            for k, v in enumerate(values)]
    n = mask.shape[-1]
    if gidx.shape[-1] != n or any(v.shape[-1] != n for v, _s in vals):
        raise ValueError("filter_agg columns differ in length")
    lib = _lib()
    stream = build.stream_ptr(mask)
    ticket = _ticket(mask.device, stream, B)
    rows, results = [], []
    for start, stop in value_chunks(n_groups, len(vals)):
        chunk = vals[start:stop]
        k = max(len(chunk), 1)
        nb, ws, res = _result_rows(n, n_groups, len(chunk), B, mask.device)
        build.check(lib.repro_filter_agg_batched(
            build.ptr(mask), ms, build.ptr(gidx), gs,
            (ctypes.c_void_p * k)(*[v.data_ptr() for v, _s in chunk]),
            (ctypes.c_longlong * k)(*[st for _v, st in chunk]), len(chunk),
            B, n, n_groups, nb, build.ptr(ws), res.data_ptr(), res.stride(0),
            build.ptr(ticket), stream), "filter_agg_batched")
        build.bump(launches, "filter_agg_batched")
        rows.append(res)
        results.append(agg_unpack(res, n_groups, len(chunk)))
    return _batched_result(rows, results)


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


def selective_batch_source(cols: dict, kinds, pred_fn, value_fns: list,
                           gidx_fn, n_groups: int) -> tuple[str, str]:
    """(library name, generated source) of the batched selective
    pipeline at capacity 0; `cols` are one binding's views."""
    em = codegen.emitter(cols, pred_fn.param_names, list(kinds))
    radix = gidx_fn.radix if gidx_fn is not None else []
    return "selective_agg_batched", codegen.selective_agg_batch_source(
        pred_fn.expr, [f.expr for f in value_fns], radix, n_groups, em)


def _selective_batch_lib(cols, kinds, pred_fn, value_fns, gidx_fn,
                         n_groups):
    """The batched instance's library: keyed apart from the scalar one."""
    key = ("batched",) + selective_key(cols, list(kinds), pred_fn,
                                       value_fns, gidx_fn, n_groups)
    lib = _GEN_LIBS.get(key)
    if lib is None:
        lib = build.load(*selective_batch_source(cols, kinds, pred_fn,
                                                 value_fns, gidx_fn,
                                                 n_groups))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_selective_agg_batched.argtypes = [
            vp, vp, vp, ll, vp, ll, i, ll, i, i, vp, vp, ll, vp, vp]
        lib.repro_selective_agg_batched.restype = ctypes.c_int
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


def _selective_batched_cuda(cols: dict, fp, ip, kinds, pred_fn,
                            value_fns: list, gidx_fn, n_groups: int):
    B, views, ptrs, strides, (fp, fps), (ip, ips) = \
        batch_operands(cols, fp, ip)
    _check_batch(B)
    first = next(iter(views.values()))
    n = first.shape[0]
    if gidx_fn is not None and gidx_fn.n_groups != n_groups:
        raise ValueError("group index and n_groups disagree")
    chunks = value_chunks(n_groups, len(value_fns))
    dev = first.device
    stream = build.stream_ptr(first)
    ticket = _ticket(dev, stream, B)
    k = len(ptrs)
    col_ptrs = (ctypes.c_void_p * k)(*ptrs)
    col_strides = (ctypes.c_longlong * k)(*strides)
    rows, results = [], []
    for start, stop in chunks:
        fns = value_fns[start:stop]
        lib = _selective_batch_lib(views, kinds, pred_fn, fns, gidx_fn,
                                   n_groups)
        nb, ws, res = _result_rows(n, n_groups, len(fns), B, dev)
        build.check(lib.repro_selective_agg_batched(
            col_ptrs, col_strides, build.ptr(fp), fps, build.ptr(ip), ips, B,
            n, n_groups, nb, build.ptr(ws), res.data_ptr(), res.stride(0),
            build.ptr(ticket), stream), "selective_filter_agg_batched")
        rows.append(res)
        results.append(agg_unpack(res, n_groups, len(fns)))
    build.bump(launches, "selective_filter_agg_batched", len(chunks))
    return _batched_result(rows, results)


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


def filter_agg_batched(mask, gidx, values: list, n_groups: int):
    """B bindings of `filter_agg`: each operand (n,) shared or (B, n);
    `(sums (B, G, A), counts (B, G))`, one launch a chunk on the card."""
    G, A = int(n_groups), len(values)
    return agg_unpack(filter_agg_batched_packed(mask, gidx, list(values), G),
                      G, A)[:2]


def selective_filter_agg_batched(cols: dict, fp, ip, kinds, pred_fn,
                                 value_fns: list, gidx_fn, n_groups: int):
    """B bindings of `selective_filter_agg` at capacity 0: each column
    (n,) shared or (B, n), the parameters as `compact.param_vectors`
    gives them; `(sums (B, G, A), counts (B, G), total (B,))`."""
    return agg_unpack(selective_filter_agg_batched_packed(
        cols, fp, ip, kinds, pred_fn, value_fns, gidx_fn, n_groups),
        int(n_groups), len(value_fns))


# the packed forms, the outputs of the engine's custom operators' vmap
# rules

def filter_agg_batched_packed(mask, gidx, values: list, n_groups: int):
    if mask.device.type == "cpu":
        sums, counts = filter_agg_batched_plain(mask, gidx, values, n_groups)
        total = mask.sum(-1, dtype=torch.int32).expand(counts.shape[0])
        return agg_pack(sums, counts, total)
    return _filter_agg_batched_cuda(mask, gidx, list(values), int(n_groups))


def selective_filter_agg_batched_packed(cols: dict, fp, ip, kinds, pred_fn,
                                        value_fns: list, gidx_fn,
                                        n_groups: int):
    if next(iter(cols.values())).device.type == "cpu":
        return agg_pack(*selective_filter_agg_batched_plain(
            cols, fp, ip, kinds, pred_fn, value_fns, gidx_fn, n_groups))
    return _selective_batched_cuda(cols, fp, ip, kinds, pred_fn,
                                   list(value_fns), gidx_fn, int(n_groups))
