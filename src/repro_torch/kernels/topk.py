"""Masked top-k (ORDER BY <metric> DESC LIMIT k): the CUDA kernel and,
beside it, its plain torch version.

Contract (the reference's oracle `ref.masked_topk_ref`, which is
`jax.lax.top_k`): with `v = where(mask, vals, -3e38)`, padded with -3e38
up to k rows when k > n, return the k largest values of `v` and their
row ids, `(values float32[k], ids int32[k])`.  Values are ordered by
IEEE 754's total order, descending: +NaN > +inf > ... > +0 > -0 > ... >
-inf > -NaN, NaNs by their payload; among equal bit patterns the lower
row comes first.  Values come back bit for bit.  An id is -1 exactly
where `value <= -3e38` compares true: masked rows, padding, and valid
values at or below the sentinel such as -inf, which keep their value;
-NaN compares false and keeps its row.

k runs from 1 to `MAX_K`; any other k raises ValueError on either device.

Which version runs is decided by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (see
`csrc/topk.cu` for its design) or raises.  `launches` counts calls that
launched the kernels.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.compact import workspace_head

launches = {"masked_topk": 0}

NEG = float(np.float32(-3.0e38))
MAX_K = 1024           # csrc/topk.cu: kMaxK
_TAIL_WORDS = 8 + 5120  # csrc/topk.cu: kStateWords + kHistWords


def order_key(v):
    """int64 keys of float32 `v` that sort as IEEE 754's total order: the
    bits as int32, with the low 31 bits flipped where the sign is set."""
    b = v.contiguous().view(torch.int32)
    return (b ^ ((b >> 31) & 0x7FFFFFFF)).to(torch.int64)


def masked_topk_plain(vals, mask, k: int):
    """A stable descending sort of the order keys: ties keep the lower row
    first, which `torch.topk` does not promise."""
    v = torch.where(mask, vals, NEG)
    n = v.shape[0]
    if k > n:
        v = torch.cat([v, v.new_full((k - n,), NEG)])
    _, si = torch.sort(order_key(v), descending=True, stable=True)
    topi = si[:k]
    topv = v[topi]
    return topv, torch.where(topv <= NEG, -1, topi.to(torch.int32))


_STATIC: list = []


def _workspace_words(n: int, k: int) -> int:
    """int32 words of one call's workspace (`csrc/topk.cu`)."""
    return 5 * k + (5 * k) % 2 + workspace_head(max(n, k)) + _TAIL_WORDS


def _lib():
    if not _STATIC:
        lib = build.load("topk", build.static_source("topk"))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_topk_max_k.argtypes = []
        lib.repro_topk_workspace.argtypes = [ll, i]
        lib.repro_topk_workspace.restype = ll
        lib.repro_masked_topk.argtypes = [vp, vp, ll, i, vp, ll, vp]
        for fn in (lib.repro_topk_max_k, lib.repro_masked_topk):
            fn.restype = ctypes.c_int
        if lib.repro_topk_max_k() != MAX_K or any(
                lib.repro_topk_workspace(n, k) != _workspace_words(n, k)
                for n, k in ((0, 1), (37, 1024), (6_000_001, 10))):
            raise RuntimeError("topk.cu and topk.py disagree on the largest "
                               "k or the workspace")
        _STATIC.append(lib)
    return _STATIC[0]


def _masked_topk_cuda(vals, mask, k: int):
    build.check_cuda_1d("vals", vals, torch.float32)
    build.check_cuda_1d("mask", mask, torch.bool)
    n = vals.shape[0]
    if mask.shape[0] != n or mask.device != vals.device:
        raise ValueError("vals and mask differ in length or device")
    lib = _lib()
    words = _workspace_words(n, k)
    ws = torch.empty(words, dtype=torch.int32, device=vals.device)
    build.check(lib.repro_masked_topk(
        build.ptr(vals), build.ptr(mask), n, k, build.ptr(ws), words,
        build.stream_ptr(vals)), "masked_topk")
    build.bump(launches, "masked_topk")
    return ws[:k].view(torch.float32), ws[k:2 * k]


def masked_topk(vals, mask, k: int):
    """`(values (k,), ids (k,))`: the top k of `vals` where `mask`."""
    k = int(k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"masked_topk takes 1 <= k <= {MAX_K} (got {k})")
    if vals.device.type == "cpu":
        return masked_topk_plain(vals, mask, k)
    return _masked_topk_cuda(vals, mask, k)
