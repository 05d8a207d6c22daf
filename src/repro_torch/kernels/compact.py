"""Stream compaction: the CUDA kernels and, beside them, their plain torch
versions.

Contract (the reference's `compact` / `compact_translate` /
`compact_pred`): `(idx int32[capacity], count int32)` — the first
`min(count, capacity)` slots hold the valid row ids in ascending order,
pad slots are zero, and `count` is the exact number of valid rows (it may
exceed `capacity`: the caller's overflow signal).  With `translate=True`
a third output `slot_of int32[n]` holds each valid row's rank and -1 for
the others.

The batched forms (`compact_batched`, `compact_pred_batched`: the
engine's bind-many pass) take B bindings at once, each operand either
shared by every binding (one binding's shape) or batched (B in front),
and return every output with B in front: slot b is the scalar form's
output on binding b's operands.  On the card they are one launch for B
bindings (`csrc/compact.cuh`: the masks' through a wide-tile batched
scan of their own; the predicate's, where every column is shared,
through a scan whose tile serves every binding, the conjuncts that read
no parameter evaluated once a row, else through the look-back scan's
binding axis); their plain versions loop over the bindings through the
scalar plain versions.  A predicate's
parameters reach a batched form as `param_vectors` makes them: float
parameters as a float64 (B, nf) or shared (nf,) tensor, the others as
int64, with their kinds.

Each batched form also has a packed output (`*_batched_packed`), the one
tensor the engine's custom operators return (`ops.py`): `[count, idx
(capacity), slot_of (n, with translate)]` a binding, which `unpack`
splits; `pack` makes it from the scalar form's outputs.

Which version runs is decided by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (see
`csrc/compact.cuh` for its design) or raises.  `launches` counts kernel
launches only, a batched launch once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, codegen

launches = {"compact": 0, "compact_pred": 0, "compact_batched": 0,
            "compact_pred_batched": 0}
# the launches of `compact_pred_batched` by route: "staged" (every column
# shared: one tile for every binding, the columns read once a tile,
# `shared_tile`) or "unstaged" (a column differs by binding: a block a
# binding and tile)
staging = {"staged": 0, "unstaged": 0}


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


def pack(out) -> torch.Tensor:
    """`(idx, count[, slot_of])` as the packed output `[count, idx,
    slot_of]` (B in front where the outputs have it)."""
    idx, count, *slot = out
    return torch.cat([count.reshape(*idx.shape[:-1], 1).to(torch.int32), idx,
                      *slot], -1)


def unpack(packed, capacity: int, translate: bool):
    """The packed output as `(idx, count[, slot_of])`, views of it."""
    out = (packed[..., 1:capacity + 1], packed[..., 0])
    return out + (packed[..., capacity + 1:],) if translate else out


def batch_size(*operands) -> int:
    """B of a batched call: the leading extent of its batched operands,
    which every one of them must share; each operand is one binding's
    (`shared` dims) or has B in front."""
    sizes = {t.shape[0] for t, shared in operands if t.ndim == shared + 1}
    if len(sizes) != 1:
        raise ValueError(f"a batched call needs one batch size, got "
                         f"{sorted(sizes)}")
    return sizes.pop()


def binding(t, b: int, shared_ndim: int):
    """Binding b's view of an operand that is shared or has B in front."""
    return t if t.ndim == shared_ndim else t[b]


def param_vectors(scalars: list):
    """`(fp, ip, kinds)`: a call's parameters as the kernels read them:
    fp holds the float ones as float64, ip the others as int64,
    positional per kind, and kinds names each one's kind.  Python
    numbers (shared by every binding) make a CPU vector (nf,); tensors,
    0-d (a batched walk's, which vmap maps) or (B,), stack on their
    device into (nf,) or (B, nf), Python numbers among them broadcast."""
    kinds = tuple(codegen._scalar_type(v) for v in scalars)

    def vec(vals, dtype):
        ts = [v for v in vals if isinstance(v, torch.Tensor)]
        if not ts:
            return torch.tensor([float(v) if dtype == torch.float64
                                 else int(v) for v in vals], dtype=dtype)
        return torch.stack(torch.broadcast_tensors(
            *[torch.as_tensor(v, device=ts[0].device).to(dtype)
              for v in vals]), -1)

    return (vec([v for v, k in zip(scalars, kinds) if k == "float"],
                torch.float64),
            vec([v for v, k in zip(scalars, kinds) if k != "float"],
                torch.int64), kinds)


def binding_scalars(fp, ip, kinds, b: int) -> list:
    """Binding b's parameters as Python scalars, in order (a shared
    vector serves every binding)."""
    fv = binding(fp, b, 1).tolist()
    iv = binding(ip, b, 1).tolist()
    out = []
    for k in kinds:
        if k == "float":
            out.append(fv.pop(0))
        else:
            v = iv.pop(0)
            out.append(bool(v) if k == "bool" else v)
    return out


def compact_batched_plain(mask, capacity: int, translate: bool = False):
    """B masks (B, n): the scalar plain version per binding, stacked."""
    return tuple(torch.stack(o) for o in zip(*[
        compact_plain(m, capacity, translate) for m in mask]))


def compact_pred_batched_plain(cols: dict, fp, ip, kinds, pred_fn,
                               capacity: int, translate: bool = False):
    """B bindings of `compact_pred_plain` (see `param_vectors`)."""
    B = batch_size(*[(t, 1) for t in cols.values()], (fp, 1), (ip, 1))
    return tuple(torch.stack(o) for o in zip(*[
        compact_pred_plain({k: binding(t, b, 1) for k, t in cols.items()},
                           binding_scalars(fp, ip, kinds, b), pred_fn,
                           capacity, translate) for b in range(B)]))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

TILE_ROWS = 4096        # csrc/compact.cuh: kCompactRows
BATCH_TILE_ROWS = 16384  # csrc/compact.cuh: kBatchTileRows (compact_batched)
BATCH_PAD_WORDS = 32768  # csrc/compact.cuh: kBatchPadWords

_STATIC: list = []


def _lib():
    if not _STATIC:
        lib = build.load("compact", build.static_source("compact"))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_compact_tile_rows.argtypes = []
        lib.repro_compact_batched_tile_rows.argtypes = []
        lib.repro_compact_batched_row_words.argtypes = [ll, i, i]
        lib.repro_compact_batched_row_words.restype = ll
        lib.repro_compact.argtypes = [vp, ll, vp, ll, i, i, vp]
        lib.repro_compact_batched.argtypes = [vp, ll, i, ll, vp, ll, i, i,
                                              vp]
        for fn in (lib.repro_compact_tile_rows,
                   lib.repro_compact_batched_tile_rows, lib.repro_compact,
                   lib.repro_compact_batched):
            fn.restype = ctypes.c_int
        lib.repro_compact_tile_row_words.argtypes = [ll, i, i]
        lib.repro_compact_tile_row_words.restype = ll
        if (lib.repro_compact_tile_rows() != TILE_ROWS
                or lib.repro_compact_batched_tile_rows() != BATCH_TILE_ROWS
                or lib.repro_compact_batched_row_words(
                    BATCH_TILE_ROWS + 1, 5, 1)
                != batched_row_words(BATCH_TILE_ROWS + 1, 5, True)
                or lib.repro_compact_tile_row_words(TILE_ROWS + 1, 5, 1)
                != tile_row_words(TILE_ROWS + 1, 5, True)):
            raise RuntimeError("compact.cuh and compact.py disagree on the "
                               "tiles or the batched workspace")
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


def row_words(n: int, capacity: int, translate: bool) -> int:
    """int32 words of one binding's row of a batched workspace: the
    scalar layout padded to a quad (`csrc/compact.cuh`)."""
    return (workspace_head(n) + capacity + (n if translate else 0) + 3) \
        // 4 * 4


def _batch_workspace(B: int, n: int, capacity: int, translate: bool,
                     device):
    """The workspace of B bindings: one row of `row_words` each."""
    return torch.empty((B, row_words(n, capacity, translate)),
                       dtype=torch.int32, device=device)


def _packed_view(ws, n: int, capacity: int, translate: bool,
                 head: int | None = None):
    """The packed outputs `[count, idx, slot_of]` of a workspace (its
    rows, B in front where it has them), a view of it; `head` is the
    words before idx (the scalar layout's by default)."""
    head = workspace_head(n) if head is None else head
    return ws[..., head - 1:head + capacity + (n if translate else 0)]


# `compact_batched`'s own layout (csrc/compact.cuh, the wide-tile batched
# scan): a row a binding, [status 2 per tile][ticket][padding][total]
# [idx][slot_of], the head a multiple of 4 words so idx is 16-byte aligned

def batched_tiles(n: int) -> int:
    """Tiles of one binding of `compact_batched`."""
    return -(-n // BATCH_TILE_ROWS)


def batched_head(n: int) -> int:
    """int32 words before idx in a `compact_batched` row: the status
    words, the ticket and the total, padded to a quad."""
    return (2 * batched_tiles(n) + 2 + 3) // 4 * 4


def batched_row_words(n: int, capacity: int, translate: bool) -> int:
    """int32 words of one binding's `compact_batched` row, a quad
    multiple."""
    return (batched_head(n) + capacity + (n if translate else 0) + 3) \
        // 4 * 4


# the predicate's shared-tile layout (csrc/compact.cuh, compact_tile_kernel):
# a row a binding, [status 2 per tile][ticket][padding][total][idx]
# [slot_of], its tiles the scalar TILE_ROWS, the head a multiple of 4 words

def tile_head(n: int) -> int:
    """int32 words before idx in a shared-tile row."""
    return (2 * (-(-n // TILE_ROWS)) + 2 + 3) // 4 * 4


def tile_row_words(n: int, capacity: int, translate: bool) -> int:
    """int32 words of one binding's shared-tile row, a quad multiple."""
    return (tile_head(n) + capacity + (n if translate else 0) + 3) // 4 * 4


# shared memory the tile's copy of the bound conjuncts' columns may take
# (TILE_ROWS rows of them), within a block's 227 KB beside the kernel's own
TILE_SMEM_MAX = 200 * 1024
# a predicate's tile bytes a row, by its expression's key and column types
# (the split walks the tree: a call's host cost is kept off it)
_TILE_ROW_BYTES: dict[tuple, int] = {}


def shared_tile(cols: dict, pred_fn) -> bool:
    """Whether a batched predicate compaction takes the shared-tile scan:
    every column is one binding's shape (every binding shares it), and
    the columns its parameterised conjuncts read fit the tile's copy in
    shared memory.  A column that differs by binding takes the look-back
    scan's binding axis, a block a binding and tile."""
    if any(t.ndim != 1 for t in cols.values()):
        return False
    types = codegen.column_types(cols)
    key = (codegen.expr_key(pred_fn.expr), tuple(types.items()))
    row = _TILE_ROW_BYTES.get(key)
    if row is None:
        if len(_TILE_ROW_BYTES) >= 4096:
            _TILE_ROW_BYTES.clear()
        row = _TILE_ROW_BYTES[key] = codegen.tile_row_bytes(
            codegen.Emitter(types, {}), pred_fn.expr)
    return row * codegen.TILE_ROWS <= TILE_SMEM_MAX


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


def _batch_rows(t, what: str, dtype=None):
    """A batched CUDA operand (B, n) whose rows are contiguous, and its
    binding stride in elements."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} is on {t.device}, the kernel needs CUDA")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what} is {t.dtype}, the kernel takes {dtype}")
    if t.ndim != 2:
        raise ValueError(f"{what} must be (B, n)")
    if t.stride(1) != 1 and t.shape[1] > 1:
        t = t.contiguous()
    return t, t.stride(0)


def _check_batch(B: int):
    if not 0 < B < 65536:
        raise ValueError(f"{B} bindings: the grid's y extent takes 1 to "
                         "65,535")


def _compact_batched_cuda(mask, capacity: int, translate: bool):
    mask, stride = _batch_rows(mask, "mask", torch.bool)
    B, n = mask.shape
    _check_batch(B)
    _check_capacity(capacity)
    ws = torch.empty((B, batched_row_words(n, capacity, translate)),
                     dtype=torch.int32, device=mask.device)
    build.check(_lib().repro_compact_batched(
        build.ptr(mask), stride, B, n, build.ptr(ws), ws.numel(), capacity,
        int(translate), build.stream_ptr(mask)), "compact_batched")
    build.bump(launches, "compact_batched")
    return _packed_view(ws, n, capacity, translate, batched_head(n))


def pred_source(cols: dict, scalars: list, pred_fn) -> tuple[str, str]:
    """(library name, generated source) of the predicate's compaction."""
    em = codegen.emitter(cols, pred_fn.param_names, scalars)
    return "compact_pred", codegen.compact_pred_source(pred_fn.expr, em)


def pred_key(cols: dict, scalars: list, pred_fn) -> tuple:
    """The generated library's key: everything its source depends on,
    cheaper to make than the source."""
    return (codegen.expr_key(pred_fn.expr),
            codegen.operand_key(cols, pred_fn.param_names, scalars))


def pred_batch_source(cols: dict, kinds, pred_fn) -> tuple[str, str]:
    """(library name, generated source) of the predicate's batched
    compaction; `cols` are one binding's views."""
    em = codegen.emitter(cols, pred_fn.param_names, list(kinds))
    return "compact_pred_batched", codegen.compact_pred_batch_source(
        pred_fn.expr, em)


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


def _pred_batch_lib(cols: dict, kinds, pred_fn):
    """The batched instance's library: keyed apart from the scalar one."""
    key = ("batched",) + pred_key(cols, list(kinds), pred_fn)
    lib = _PRED_LIBS.get(key)
    if lib is None:
        lib = build.load(*pred_batch_source(cols, kinds, pred_fn))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.repro_compact_pred_batched,
                   lib.repro_compact_pred_batched_tile):
            fn.argtypes = [vp, vp, vp, ll, vp, ll, i, ll, vp, ll, i, i, vp]
            fn.restype = ctypes.c_int
        _PRED_LIBS[key] = lib
    return lib


def batch_operands(cols: dict, fp, ip):
    """(B, one binding's column views, column pointers, their binding
    strides, (fp, fp's row stride), (ip, ip's row stride)) of a batched
    generated launch: a shared column or vector has stride 0."""
    B = batch_size(*[(t, 1) for t in cols.values()], (fp, 1), (ip, 1))
    views, ptrs, strides = {}, [], []
    for name, t in cols.items():
        if t.ndim == 2:
            if t.device.type != "cuda":
                raise ValueError(f"{name} is on {t.device}, the kernel "
                                 "needs CUDA")
            views[name] = t[0]
            strides.append(t.stride(0))
        else:
            views[name] = t
            strides.append(0)
        build.check_cuda_column(name, views[name])
        ptrs.append(t.data_ptr())
    n = next(iter(views.values())).shape[0]
    if any(t.shape[0] != n for t in views.values()):
        raise ValueError("batched columns differ in length")

    def vec(v):
        if v.device.type != "cuda":
            v = v.to(next(iter(cols.values())).device)
        if v.ndim == 2 and v.stride(1) != 1 and v.shape[1] > 1:
            v = v.contiguous()
        return v, (v.stride(0) if v.ndim == 2 else 0)

    return (B, views, ptrs, strides, vec(fp), vec(ip))


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


def _compact_pred_batched_cuda(cols: dict, fp, ip, kinds, pred_fn,
                               capacity: int, translate: bool):
    _check_capacity(capacity)
    tiled = shared_tile(cols, pred_fn)
    B, views, ptrs, strides, (fp, fps), (ip, ips) = \
        batch_operands(cols, fp, ip)
    _check_batch(B)
    first = next(iter(views.values()))
    n = first.shape[0]
    lib = _pred_batch_lib(views, kinds, pred_fn)
    if tiled:
        _lib()      # the static library's check of the tile layout
        ws = torch.empty((B, tile_row_words(n, capacity, translate)),
                         dtype=torch.int32, device=first.device)
        launch, head = lib.repro_compact_pred_batched_tile, tile_head(n)
    else:
        ws = _batch_workspace(B, n, capacity, translate, first.device)
        launch, head = lib.repro_compact_pred_batched, None
    k = len(ptrs)
    build.check(launch(
        (ctypes.c_void_p * k)(*ptrs), (ctypes.c_longlong * k)(*strides),
        build.ptr(fp), fps, build.ptr(ip), ips, B, n, build.ptr(ws),
        ws.numel(), capacity, int(translate), build.stream_ptr(ws)),
        "compact_pred_batched")
    build.bump(staging, "staged" if tiled else "unstaged")
    build.bump(launches, "compact_pred_batched")
    return _packed_view(ws, n, capacity, translate, head)


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


def compact_batched(mask, capacity: int, translate: bool = False):
    """B masks (B, n): `(idx (B, capacity), count (B,)[, slot_of (B,
    n)])`, one launch on the card."""
    return unpack(compact_batched_packed(mask, capacity, translate),
                  int(capacity), translate)


def compact_pred_batched(cols: dict, fp, ip, kinds, pred_fn, capacity: int,
                         translate: bool = False):
    """B bindings of `compact_pred`: each column (n,) shared or (B, n),
    the parameters as `param_vectors` gives them; outputs as
    `compact_batched`'s, one launch on the card."""
    return unpack(compact_pred_batched_packed(cols, fp, ip, kinds, pred_fn,
                                              capacity, translate),
                  int(capacity), translate)


# the packed forms, the outputs of the engine's custom operators' vmap
# rules

def compact_batched_packed(mask, capacity: int, translate: bool = False):
    if mask.device.type == "cpu":
        return pack(compact_batched_plain(mask, capacity, translate))
    return _compact_batched_cuda(mask, int(capacity), translate)


def compact_pred_batched_packed(cols: dict, fp, ip, kinds, pred_fn,
                                capacity: int, translate: bool = False):
    if next(iter(cols.values())).device.type == "cpu":
        return pack(compact_pred_batched_plain(cols, fp, ip, kinds, pred_fn,
                                               capacity, translate))
    return _compact_pred_batched_cuda(cols, fp, ip, kinds, pred_fn,
                                      int(capacity), translate)
