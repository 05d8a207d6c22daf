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

TILE_ROWS = 4096        # csrc/compact.cuh: kCompactRows

_STATIC: list = []


def _lib():
    if not _STATIC:
        lib = build.load("compact", build.static_source("compact"))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_compact_tile_rows.argtypes = []
        lib.repro_compact.argtypes = [vp, ll, vp, ll, i, i, vp]
        for fn in (lib.repro_compact_tile_rows, lib.repro_compact):
            fn.restype = ctypes.c_int
        if lib.repro_compact_tile_rows() != TILE_ROWS:
            raise RuntimeError("compact.cuh and compact.py disagree on the "
                               "tile")
        _STATIC.append(lib)
    return _STATIC[0]


def workspace_head(n: int) -> int:
    """int32 words before `idx` in the workspace: two per tile of status,
    the ticket, the total (`csrc/compact.cuh`)."""
    return 2 * (-(-n // TILE_ROWS)) + 2


def _workspace(n: int, capacity: int, translate: bool, device):
    """(workspace, outputs as views of it): one allocation per call."""
    head = workspace_head(n)
    slot = n if translate else 0
    ws = torch.empty(head + capacity + slot, dtype=torch.int32,
                     device=device)
    out = (ws[head:head + capacity], ws[head - 1])
    if translate:
        out += (ws[head + capacity:head + capacity + n],)
    return ws, out


def rank_mask_cuda(mask, capacity: int, translate: bool):
    """The one-launch compaction of a contiguous CUDA bool mask, with no
    check and no count of launches: for the wrappers that own them."""
    n = mask.shape[0]
    ws, out = _workspace(n, capacity, translate, mask.device)
    build.check(_lib().repro_compact(
        build.ptr(mask), n, build.ptr(ws), ws.shape[0], capacity,
        int(translate), build.stream_ptr(mask)), "compact")
    return out


def _check_capacity(capacity: int):
    if not 0 < capacity < 2**31:
        raise ValueError(f"capacity {capacity} out of range")


def _compact_cuda(mask, capacity: int, translate: bool):
    build.check_cuda_1d("mask", mask, torch.bool)
    _check_capacity(capacity)
    out = rank_mask_cuda(mask, capacity, translate)
    build.bump(launches, "compact")
    return out


def pred_source(cols: dict, scalars: list, pred_fn) -> tuple[str, str]:
    """(library name, generated source) of the predicate's compaction."""
    em = codegen.emitter(cols, pred_fn.param_names, scalars)
    return "compact_pred", codegen.compact_pred_source(pred_fn.expr, em)


def pred_key(cols: dict, scalars: list, pred_fn) -> tuple:
    """The generated library's key: everything its source depends on,
    cheaper to make than the source."""
    return (codegen.expr_key(pred_fn.expr),
            codegen.operand_key(cols, pred_fn.param_names, scalars))


_PRED_LIBS: dict[tuple, ctypes.CDLL] = {}


def _pred_lib(cols: dict, scalars: list, pred_fn):
    key = pred_key(cols, scalars, pred_fn)
    lib = _PRED_LIBS.get(key)
    if lib is None:
        lib = build.load(*pred_source(cols, scalars, pred_fn))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_compact_pred.argtypes = [vp, vp, vp, ll, vp, ll, i, i, vp]
        lib.repro_compact_pred.restype = ctypes.c_int
        _PRED_LIBS[key] = lib
    return lib


def _compact_pred_cuda(cols: dict, scalars: list, pred_fn, capacity: int,
                       translate: bool):
    for name, t in cols.items():
        build.check_cuda_column(name, t)
    first = next(iter(cols.values()))
    n = first.shape[0]
    if any(t.shape[0] != n for t in cols.values()):
        raise ValueError("compact_pred columns differ in length")
    _check_capacity(capacity)
    plib = _pred_lib(cols, scalars, pred_fn)
    ws, out = _workspace(n, capacity, translate, first.device)
    fp, ip = codegen.split_scalars(pred_fn.param_names, scalars)
    build.check(plib.repro_compact_pred(
        (ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols.values()]),
        (ctypes.c_double * max(len(fp), 1))(*fp),
        (ctypes.c_longlong * max(len(ip), 1))(*ip),
        n, build.ptr(ws), ws.shape[0], capacity, int(translate),
        build.stream_ptr(first)), "compact_pred")
    build.bump(launches, "compact_pred")
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
