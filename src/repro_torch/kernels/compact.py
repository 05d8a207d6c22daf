"""Stream compaction: the CUDA kernels and, beside them, their plain torch
versions.

Contract (the reference's `compact` / `compact_translate` /
`compact_pred`): `(idx int32[capacity], count int32)` — the first
`min(count, capacity)` slots hold the valid row ids in ascending order,
pad slots are zero, and `count` is the exact number of valid rows (it may
exceed `capacity`: the caller's overflow signal).  With `translate=True`
a third output `slot_of int32[n]` holds each valid row's rank and -1 for
the others.

Which version runs is decided by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (see
`csrc/compact.cuh` for its design) or raises.  `launches` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, codegen

launches = {"compact": 0, "compact_pred": 0}


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def compact_plain(mask, capacity: int, translate: bool = False):
    n = mask.shape[0]
    c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    count = c[-1] if n else torch.zeros((), dtype=torch.int32,
                                        device=mask.device)
    slots = torch.arange(1, capacity + 1, dtype=torch.int32,
                         device=mask.device)
    pos = torch.searchsorted(c, slots, out_int32=True).clamp_(0, max(n - 1, 0))
    idx = torch.where(slots <= count, pos, 0)
    if translate:
        return idx, count, torch.where(mask, c - 1, -1).to(torch.int32)
    return idx, count


def _pred_mask(cols: dict, scalars: list, pred_fn):
    n = next(iter(cols.values())).shape[0]
    dev = next(iter(cols.values())).device
    m = pred_fn(cols, scalars)
    if not isinstance(m, torch.Tensor):
        m = torch.tensor(bool(m), device=dev)
    return m.to(torch.bool).expand(n)


def compact_pred_plain(cols: dict, scalars: list, pred_fn, capacity: int,
                       translate: bool = False):
    return compact_plain(_pred_mask(cols, scalars, pred_fn), capacity,
                         translate)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_STATIC: list = []


def _lib():
    if not _STATIC:
        lib = build.load("compact", build.static_source("compact"))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_compact_blocks.argtypes = [ll]
        lib.repro_compact_count.argtypes = [vp, ll, vp, vp]
        lib.repro_compact_scan_write.argtypes = [vp, ll, vp, vp, vp, vp, i,
                                                 vp, vp]
        for fn in (lib.repro_compact_blocks, lib.repro_compact_count,
                   lib.repro_compact_scan_write):
            fn.restype = ctypes.c_int
        _STATIC.append(lib)
    return _STATIC[0]


def _scan_write(lib, mask, n, counts, capacity, translate):
    dev = mask.device
    idx = torch.zeros(capacity, dtype=torch.int32, device=dev)
    offsets = torch.empty_like(counts)
    total = torch.empty((), dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev) if translate \
        else None
    build.check(lib.repro_compact_scan_write(
        build.ptr(mask), n, build.ptr(counts), build.ptr(offsets),
        build.ptr(total), build.ptr(idx), capacity, build.ptr(slot),
        build.stream_ptr(mask)), "compact scan/write")
    return (idx, total, slot) if translate else (idx, total)


def rank_mask_cuda(mask, capacity: int, translate: bool):
    """The three compaction passes over a contiguous CUDA bool mask, with
    no check and no count of launches: for the wrappers that own them."""
    lib = _lib()
    n = mask.shape[0]
    counts = torch.empty(max(lib.repro_compact_blocks(n), 1),
                         dtype=torch.int32, device=mask.device)
    build.check(lib.repro_compact_count(
        build.ptr(mask), n, build.ptr(counts), build.stream_ptr(mask)),
        "compact count")
    return _scan_write(lib, mask, n, counts, capacity, translate)


def _check_capacity(capacity: int):
    if not 0 < capacity < 2**31:
        raise ValueError(f"capacity {capacity} out of range")


def _compact_cuda(mask, capacity: int, translate: bool):
    build.check_cuda_1d("mask", mask, torch.bool)
    _check_capacity(capacity)
    out = rank_mask_cuda(mask, capacity, translate)
    launches["compact"] += 1
    return out


def pred_source(cols: dict, scalars: list, pred_fn) -> tuple[str, str]:
    """(library name, generated source) of the predicate's count pass."""
    em = codegen.Emitter(codegen.column_types(cols),
                         codegen.param_types(pred_fn.param_names, scalars))
    return "compact_pred", codegen.compact_pred_source(pred_fn.expr, em)


_PRED_LIBS: dict[str, ctypes.CDLL] = {}


def _pred_lib(cols: dict, scalars: list, pred_fn):
    name, src = pred_source(cols, scalars, pred_fn)
    lib = _PRED_LIBS.get(src)
    if lib is None:
        lib = build.load(name, src)
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.repro_pred_count.argtypes = [vp, vp, vp, ll, vp, vp, vp]
        lib.repro_pred_count.restype = ctypes.c_int
        _PRED_LIBS[src] = lib
    return lib


def _compact_pred_cuda(cols: dict, scalars: list, pred_fn, capacity: int,
                       translate: bool):
    for name, t in cols.items():
        build.check_cuda_1d(name, t)
    n = next(iter(cols.values())).shape[0]
    if any(t.shape[0] != n for t in cols.values()):
        raise ValueError("compact_pred columns differ in length")
    _check_capacity(capacity)
    lib, plib = _lib(), _pred_lib(cols, scalars, pred_fn)
    dev = next(iter(cols.values())).device
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(max(lib.repro_compact_blocks(n), 1),
                         dtype=torch.int32, device=dev)
    fp, ip = codegen.split_scalars(pred_fn.param_names, scalars)
    build.check(plib.repro_pred_count(
        (ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols.values()]),
        (ctypes.c_double * max(len(fp), 1))(*fp),
        (ctypes.c_longlong * max(len(ip), 1))(*ip),
        n, build.ptr(mask), build.ptr(counts), build.stream_ptr(mask)),
        "compact_pred count")
    out = _scan_write(lib, mask, n, counts, capacity, translate)
    launches["compact_pred"] += 1
    return out


# ---------------------------------------------------------------------------
# entry points: the version follows the tensors' device
# ---------------------------------------------------------------------------

def compact(mask, capacity: int, *, translate: bool = False):
    """`(idx, count[, slot_of])` of a bool mask."""
    if mask.device.type == "cpu":
        return compact_plain(mask, capacity, translate)
    return _compact_cuda(mask, int(capacity), translate)


def compact_pred(cols: dict, scalars: list, pred_fn, capacity: int, *,
                 translate: bool = False):
    """Filter → compact with the predicate evaluated in-kernel: `cols`
    maps every column `pred_fn` reads to a 1-D tensor, `scalars` are its
    parameters, `pred_fn` a `fused.TileFn`."""
    if next(iter(cols.values())).device.type == "cpu":
        return compact_pred_plain(cols, scalars, pred_fn, capacity,
                                  translate)
    return _compact_pred_cuda(cols, scalars, pred_fn, int(capacity),
                              translate)
