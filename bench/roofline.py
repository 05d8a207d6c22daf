"""The yardstick's table of peaks and the bytes each engine entry point
has to move.

Peaks: NVIDIA's H100 SXM data sheet (dense rates, 700 W); the same
figures as the port's `launch/roofline.py`, copied so that the yardstick
does not move when the program does.

Bytes (the rule of PERF.md §6): every operand read once and every output
written once.  Under the bind-many pass (`torch.func.vmap`) an operand
vmap batched is read once a binding and one it left shared once for all,
and every output is written once a binding.  A group index is read as
int32 and a value column as float32, as the kernels read them.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12        # HBM3, 80 GB
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12          # outside the tensor cores

_functorch = torch._C._functorch


def bindings(x) -> int:
    """How many bindings vmap carries in `x` (1 for a plain tensor)."""
    if isinstance(x, torch.Tensor) and _functorch.is_batchedtensor(x):
        level_dim = _functorch.maybe_get_bdim(x)
        return int(_functorch.get_unwrapped(x).shape[level_dim])
    return 1


def _read(x, itemsize: int | None = None) -> tuple[int, int]:
    """(bytes one binding's view of `x` holds, bindings that read it)."""
    if not isinstance(x, torch.Tensor):
        return 0, 1
    size = itemsize if itemsize is not None else x.element_size()
    return x.numel() * size, bindings(x)


def _total(reads: list, out_bytes: int) -> int:
    b = max([n for _bytes, n in reads] + [1])
    return sum(nbytes * n for nbytes, n in reads) + out_bytes * b


def filter_agg_query(mask, gidx, value_cols, n_groups) -> int:
    reads = [_read(mask), _read(gidx, 4)] + [_read(v, 4) for v in value_cols]
    return _total(reads, 4 * int(n_groups) * (len(value_cols) + 1))


def compact_query(mask, capacity, *, translate=False) -> int:
    n = mask.shape[-1]
    return _total([_read(mask)],
                  4 * int(capacity) + 4 + (4 * n if translate else 0))


def compact_pred_query(cols, scalars, pred_fn, capacity, *,
                       translate=False) -> int:
    n = next(iter(cols.values())).shape[-1]
    return _total([_read(c) for c in cols.values()],
                  4 * int(capacity) + 4 + (4 * n if translate else 0))


def selective_agg_query(cols, scalars, pred_fn, value_fns, gidx_fn,
                        n_groups) -> int:
    reads = [_read(c) for c in cols.values()]
    return _total(reads, 4 * int(n_groups) * (len(value_fns) + 1) + 4)


ENTRY_POINTS = {"filter_agg_query": filter_agg_query,
                "compact_query": compact_query,
                "compact_pred_query": compact_pred_query,
                "selective_agg_query": selective_agg_query}


def bound_s(nbytes: int) -> float:
    """The least time the chip's memory can move `nbytes` in."""
    return nbytes / HBM_BYTES_PER_S
