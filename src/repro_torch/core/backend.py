"""Torch backend: the handful of ops whose semantics the staged program
needs spelled out, on an explicit device.

The operators run twice per compilation with this backend — once on
8-row CPU samples (the collection walk) and once on the resident inputs
(the staged walk, CPU or CUDA) — so each op here keeps the contract of
the reference package's backend:

  * `take` clamps out-of-range indices (an XLA gather clamps implicitly;
    torch indexing raises instead);
  * `segment_max`/`segment_min` leave an empty segment at `fill`;
  * `compact` zero-fills the slots past the valid count;
  * `searchsorted` is `jnp.searchsorted`'s left side.
"""
from __future__ import annotations

import torch


class TorchBackend:
    name = "torch"

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    @staticmethod
    def take(arr, idx):
        n = arr.shape[0]
        if n == 0:  # collection walk over an empty sample slice
            return torch.zeros((idx.shape[0],) + tuple(arr.shape[1:]),
                               dtype=arr.dtype, device=arr.device)
        return arr[idx.clamp(0, n - 1)]

    @staticmethod
    def segment_sum(data, ids, n):
        out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        return out.index_add_(0, ids.clamp(0, n - 1), data)

    @staticmethod
    def _segment_reduce(data, ids, n, fill, how):
        out = torch.full((n,) + tuple(data.shape[1:]), fill, dtype=data.dtype,
                         device=data.device)
        ids = ids.clamp(0, n - 1).long()
        if data.ndim > 1:
            ids = ids.view((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
        # include_self=False: a segment that receives rows reduces over
        # them alone, one that receives none keeps `fill`
        return out.scatter_reduce_(0, ids, data, reduce=how,
                                   include_self=False)

    @classmethod
    def segment_max(cls, data, ids, n, fill):
        return cls._segment_reduce(data, ids, n, fill, "amax")

    @classmethod
    def segment_min(cls, data, ids, n, fill):
        return cls._segment_reduce(data, ids, n, fill, "amin")

    @staticmethod
    def lexsort(keys):
        """numpy's `lexsort`: the LAST key is the primary one.  Chained
        stable argsorts, least-significant key first."""
        keys = list(keys)
        n = keys[0].shape[0]
        order = torch.arange(n, device=keys[0].device)
        for k in keys:
            if k.dtype == torch.bool:
                k = k.to(torch.uint8)
            order = order[torch.argsort(k[order], stable=True)]
        return order

    @staticmethod
    def searchsorted(sorted_seq, values):
        """int32 insertion points of `values` into the ascending
        `sorted_seq` (left side: the first position whose element is not
        below the value).  Both sides are brought to one dtype first
        (torch refuses a mixed pair on CUDA)."""
        dt = torch.promote_types(sorted_seq.dtype, values.dtype)
        return torch.searchsorted(sorted_seq.to(dt).contiguous(),
                                  values.to(dt).contiguous(), out_int32=True)

    @staticmethod
    def compact(mask, capacity):
        """(idx int32[capacity], count int32): row ids of the mask's valid
        rows, in order, zero-padded past `count`.  `count` may exceed
        `capacity` (the caller's overflow signal); the surplus rows are
        dropped from idx.  Cumsum + a batched binary search over the
        output slots: a gather formulation with static shapes."""
        n = mask.shape[0]
        if n == 0:
            return (torch.zeros(capacity, dtype=torch.int32,
                                device=mask.device),
                    torch.zeros((), dtype=torch.int32, device=mask.device))
        c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
        count = c[-1]
        slots = torch.arange(1, capacity + 1, dtype=torch.int32,
                             device=mask.device)
        idx = torch.searchsorted(c, slots, out_int32=True).clamp_(0, n - 1)
        return torch.where(slots <= count, idx, 0), count

    @staticmethod
    def barrier(x):
        """Eager torch has no fusion scope to cut: the identity."""
        return x
