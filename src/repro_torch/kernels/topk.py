"""Masked top-k (ORDER BY <metric> DESC LIMIT k): the CUDA kernel and,
beside it, its plain torch version.

Contract (the reference's `masked_topk` and its oracle
`ref.masked_topk_ref`): with `v = where(mask, vals, -3e38)`, padded with
-3e38 up to k rows when k > n, return the k largest values of `v` and
their row ids, `(values float32[k], ids int32[k])`, ordered by value
descending and, among equal values, by row ascending (JAX's `top_k`
order).  Every id whose value is <= -3e38 is -1: masked rows, padding,
and valid values at or below the sentinel (such as -inf), which keep
their value.  Where NaN falls in the order is not pinned down.

k runs from 1 to `MAX_K`; any other k raises ValueError on either device.

Which version runs is decided by the tensors' device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (see
`csrc/topk.cu` for its design) or raises.  `launches` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

launches = {"masked_topk": 0}

NEG = float(np.float32(-3.0e38))
MAX_K = 1024           # csrc/topk.cu: kMaxK


def masked_topk_plain(vals, mask, k: int):
    """A stable descending sort: ties keep the lower row first, which
    `torch.topk` does not promise."""
    v = torch.where(mask, vals, NEG)
    n = v.shape[0]
    if k > n:
        v = torch.cat([v, v.new_full((k - n,), NEG)])
    sv, si = torch.sort(v, descending=True, stable=True)
    topv, topi = sv[:k], si[:k].to(torch.int32)
    return topv, torch.where(topv <= NEG, -1, topi)


_STATIC: list = []


def _lib():
    if not _STATIC:
        lib = build.load("topk", build.static_source("topk"))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_topk_max_k.argtypes = []
        lib.repro_topk_scratch.argtypes = [ll, i]
        lib.repro_topk_scratch.restype = ll
        lib.repro_masked_topk.argtypes = [vp, vp, ll, i, vp, vp, vp, vp, vp]
        for fn in (lib.repro_topk_max_k, lib.repro_masked_topk):
            fn.restype = ctypes.c_int
        if lib.repro_topk_max_k() != MAX_K:
            raise RuntimeError("topk.cu and topk.py disagree on the largest k")
        _STATIC.append(lib)
    return _STATIC[0]


def _masked_topk_cuda(vals, mask, k: int):
    build.check_cuda_1d("vals", vals, torch.float32)
    build.check_cuda_1d("mask", mask, torch.bool)
    n = vals.shape[0]
    if mask.shape[0] != n or mask.device != vals.device:
        raise ValueError("vals and mask differ in length or device")
    lib = _lib()
    dev = vals.device
    m = max(lib.repro_topk_scratch(n, k), 1)
    scratch_v = torch.empty(m, dtype=torch.float32, device=dev)
    scratch_i = torch.empty(m, dtype=torch.int32, device=dev)
    out_v = torch.empty(k, dtype=torch.float32, device=dev)
    out_i = torch.empty(k, dtype=torch.int32, device=dev)
    build.check(lib.repro_masked_topk(
        build.ptr(vals), build.ptr(mask), n, k, build.ptr(scratch_v),
        build.ptr(scratch_i), build.ptr(out_v), build.ptr(out_i),
        build.stream_ptr(vals)), "masked_topk")
    launches["masked_topk"] += 1
    return out_v, out_i


def masked_topk(vals, mask, k: int):
    """`(values (k,), ids (k,))`: the top k of `vals` where `mask`."""
    k = int(k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"masked_topk takes 1 <= k <= {MAX_K} (got {k})")
    if vals.device.type == "cpu":
        return masked_topk_plain(vals, mask, k)
    return _masked_topk_cuda(vals, mask, k)
