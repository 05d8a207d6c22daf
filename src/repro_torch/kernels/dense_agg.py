"""Dense aggregation over a large key domain: the CUDA kernel and, beside
it, its plain torch version.

  dense_agg(mask, gidx, values, carries, n_groups)
      -> (sums [float32 (D,)] * A, counts int32 (D,), carried [(D,)] * C)

For each group g of `[0, D)`, over the rows where `mask` holds and
`gidx` is g: the sum of each float32 value column, the number of rows,
and the max of each carry column (int32 or float32, each kept in its
dtype).  The engine's dense aggregation takes it past the domains whose
accumulators fit one block's shared memory (`filter_agg`).  The batched
form (`dense_agg_batched_packed`, the engine's bind-many pass) takes B
bindings at once, each operand shared (one binding's shape) or with B in
front, and returns the packed rows, one a binding:

    [counts D][sums of value 0 D] ... [carry 0 D] ...   (int32 words)

which `unpack` splits into views; `pack` makes a row from the scalar
form's outputs.

The plain version is the engine's PyTorch segment operations
(`TorchBackend.segment_sum` and `segment_max` over masked copies): the
engine's dense aggregation calls it where the kernel does not serve an
unsharded one (`core/operators/agg.py`: the rungs without kernels,
other dtypes), and a CPU run answers as the engine did before the
kernel: a group that
receives no row keeps a carry of 0, one whose rows the mask all drops a
carry of -3e38 (float) or -1 (int), and the sums are float32 `index_add`
sums.  The kernel agrees on every present group (counts exactly, sums to
float32 rounding: both add with atomics in no fixed order on the card)
and leaves every carry of an absent group at 0.  Its carries are the max
over the kept rows; the plain version's differ from that where a group
keeps only int carries below -1 and drops a row (the -1 it fills a
dropped row with stands above them): the engine's int carries are dates
and codes, none below 0.  The keys must lie
in `[0, D)` (the engine clamps them): the plain version clamps one that
does not, the kernel drops its row.

Which version runs is decided by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (see
`csrc/dense_agg.cu` for its design) or raises.  A CUDA call is one
memset and one launch, and a second launch that decodes the carries
where there are carries; it allocates only its result, through
PyTorch's allocator, reads nothing back and never synchronizes, so a
CUDA graph can capture it.  `launches` counts calls that launched, a
batched call once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.backend import TorchBackend
from repro_torch.core.operators.base import F32BIG
from repro_torch.kernels import build
from repro_torch.kernels.compact import _check_batch, batch_size, binding
from repro_torch.kernels.filter_agg import _as_float32, _operand

launches = {"dense_agg": 0, "dense_agg_batched": 0}

MAX_COLS = 8            # csrc/dense_agg.cu: kMaxCols
CARRY_DTYPES = (torch.int32, torch.float32)


def fits(n_vals: int, n_carries: int) -> bool:
    """Whether one launch takes this many value columns and carries."""
    return n_vals <= MAX_COLS and n_carries <= MAX_COLS


def kinds(carries: list) -> str:
    """Each carry's kind, "f" (float32) or "i" (int32), as one string."""
    return "".join("f" if c.dtype == torch.float32 else "i"
                   for c in carries)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------

def dense_agg_plain(mask, gidx, values: list, carries: list, n_groups: int):
    be = TorchBackend
    mi32 = mask.to(torch.int32)
    counts = be.segment_sum(mi32, gidx, n_groups)
    sums = [be.segment_sum(torch.where(mask, v, 0), gidx, n_groups)
            for v in values]
    carried = []
    for c in carries:
        if c.dtype.is_floating_point:
            carried.append(be.segment_max(torch.where(mask, c, -F32BIG),
                                          gidx, n_groups, 0.0))
        else:
            carried.append(be.segment_max(
                torch.where(mask, c, -1).to(c.dtype), gidx, n_groups, 0))
    return sums, counts, carried


def pack(sums: list, counts, carried: list):
    """The scalar form's outputs as one packed row."""
    return torch.cat([counts, *[s.view(torch.int32) for s in sums],
                      *[c.view(torch.int32) for c in carried]])


def unpack(row, n_groups: int, n_vals: int, kinds: str):
    """The packed row (B in front or not) as `(sums, counts, carried)`,
    views of it."""
    D = n_groups

    def col(k):
        return row[..., D * k:D * (k + 1)]

    sums = [_as_float32(col(1 + a)) for a in range(n_vals)]
    carried = [_as_float32(col(1 + n_vals + k)) if kind == "f"
               else col(1 + n_vals + k) for k, kind in enumerate(kinds)]
    return sums, col(0), carried


def dense_agg_batched_plain(mask, gidx, values: list, carries: list,
                            n_groups: int):
    """B bindings of `dense_agg_plain`, packed: each operand (n,) shared
    or (B, n); the rows (B, (1 + A + C) D)."""
    ops = [(mask, 1), (gidx, 1), *[(t, 1) for t in (*values, *carries)]]
    return torch.stack([
        pack(*dense_agg_plain(binding(mask, b, 1), binding(gidx, b, 1),
                              [binding(v, b, 1) for v in values],
                              [binding(c, b, 1) for c in carries],
                              n_groups))
        for b in range(batch_size(*ops))])


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_STATIC: list = []


def _lib():
    if not _STATIC:
        lib = build.load("dense_agg", build.static_source("dense_agg"))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_dense_agg_max_cols.argtypes = []
        lib.repro_dense_agg.argtypes = [vp, ll, vp, ll, vp, vp, i, vp, vp,
                                        vp, i, i, ll, i, vp, i, vp]
        for fn in (lib.repro_dense_agg_max_cols, lib.repro_dense_agg):
            fn.restype = ctypes.c_int
        if lib.repro_dense_agg_max_cols() != MAX_COLS:
            raise RuntimeError("dense_agg.cu and dense_agg.py disagree on "
                               "the columns a launch takes")
        _STATIC.append(lib)
    return _STATIC[0]


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dense_agg_cuda(mask, gidx, values: list, carries: list, n_groups: int):
    """The packed rows (B, (1 + A + C) D) of B bindings (B = 1 where
    every operand is one binding's)."""
    if not fits(len(values), len(carries)):
        raise ValueError(f"{len(values)} value columns and {len(carries)} "
                         f"carries: a launch takes at most {MAX_COLS} each")
    if not 0 < n_groups < 2**31:
        raise ValueError(f"n_groups {n_groups} out of range")
    operands = [(mask, 1), (gidx, 1), *[(t, 1) for t in (*values, *carries)]]
    B = batch_size(*operands) if any(t.ndim == 2 for t, _ in operands) \
        else 1
    _check_batch(B)
    mask, ms = _operand(mask, "mask", torch.bool)
    gidx, gs = _operand(gidx, "gidx", torch.int32)
    vals = [_operand(v, f"values[{a}]", torch.float32)
            for a, v in enumerate(values)]
    cars = []
    for k, c in enumerate(carries):
        if c.dtype not in CARRY_DTYPES:
            raise TypeError(f"carries[{k}] is {c.dtype}, the kernel takes "
                            "int32 or float32")
        cars.append(_operand(c, f"carries[{k}]", c.dtype))
    n = mask.shape[-1]
    cols = [gidx, *[t for t, _s in (*vals, *cars)]]
    if any(t.shape[-1] != n for t in cols):
        raise ValueError("dense_agg columns differ in length")
    if any(t.device != mask.device for t in cols):
        raise ValueError("dense_agg operands lie on different devices")
    A, C = len(vals), len(cars)
    out = torch.empty((B, (1 + A + C) * n_groups), dtype=torch.int32,
                      device=mask.device)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    build.check(_lib().repro_dense_agg(
        build.ptr(mask), ms, build.ptr(gidx), gs,
        (vp * max(A, 1))(*[t.data_ptr() for t, _s in vals]),
        (ll * max(A, 1))(*[s for _t, s in vals]), A,
        (vp * max(C, 1))(*[t.data_ptr() for t, _s in cars]),
        (ll * max(C, 1))(*[s for _t, s in cars]),
        (ctypes.c_int * max(C, 1))(*[int(t.dtype == torch.float32)
                                     for t, _s in cars]), C,
        B, n, n_groups, build.ptr(out), _sms(mask.device.index),
        build.stream_ptr(mask)), "dense_agg")
    return out


# ---------------------------------------------------------------------------
# entry points: the version follows the tensors' device
# ---------------------------------------------------------------------------

def dense_agg(mask, gidx, values: list, carries: list, n_groups: int):
    """`(sums, counts, carried)` over the rows where `mask` holds, grouped
    by `gidx` into `n_groups` groups (the module's docstring)."""
    if mask.device.type == "cpu":
        return dense_agg_plain(mask, gidx, list(values), list(carries),
                               int(n_groups))
    row = _dense_agg_cuda(mask, gidx, list(values), list(carries),
                          int(n_groups))
    build.bump(launches, "dense_agg")
    return unpack(row[0], int(n_groups), len(values), kinds(carries))


def dense_agg_batched_packed(mask, gidx, values: list, carries: list,
                             n_groups: int):
    """B bindings of `dense_agg`: each operand (n,) shared or (B, n); the
    packed rows (B, (1 + A + C) D), one launch on the card."""
    if mask.device.type == "cpu":
        return dense_agg_batched_plain(mask, gidx, list(values),
                                       list(carries), int(n_groups))
    rows = _dense_agg_cuda(mask, gidx, list(values), list(carries),
                           int(n_groups))
    build.bump(launches, "dense_agg_batched")
    return rows
