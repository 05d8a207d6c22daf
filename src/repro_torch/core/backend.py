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
  * `searchsorted` is `jnp.searchsorted`'s left side;
  * the mesh collectives (`psum`, `pmax`, `pmin`, `all_gather`,
    `axis_index`) act on the shard group the staged walk is bound to
    (`core/mesh.py`), and are identities on the collection walk, which
    has no group: sharded staging decisions see a one-shard world there.

A batched (vmapped) staged walk hands its backend a `token`, a tensor
vmap batches over the bindings.  Every collective then calls one
custom operator (`repro_torch::collective`) with the token beside its
value, so that the operator's vmap rule runs in every shard, whether
that shard's value depends on the bindings or not.  The rule deposits a
plain tensor (the bindings in front where the value is batched), and
combines as the scalar walk does: a value no shard batched stays one
value, and where some shard's is batched every unbatched one is
expanded to the bindings first.  Each binding's result is the scalar
collective's, bit for bit.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import mesh

_FOLDS = {"psum": torch.add, "pmax": torch.maximum, "pmin": torch.minimum}


def combine(vals: list, how: str, dim: int = 0):
    """Every shard's value, in rank order, combined: a reduction
    (`psum`, `pmax`, `pmin`) folds them left to right; `gather` and
    `stack` concatenate them along `dim` or stack them at it."""
    if how == "gather":
        return torch.cat(vals, dim)
    if how == "stack":
        return torch.stack(vals, dim)
    return functools.reduce(_FOLDS[how], vals[1:], vals[0])


@torch.library.custom_op("repro_torch::collective", mutates_args=())
def _collective_op(x: torch.Tensor, token: torch.Tensor, group: int,
                   rank: int, how: str) -> torch.Tensor:
    return combine(mesh.group_of(group).exchange(rank, x), how)


@_collective_op.register_vmap
def _collective_vmap(info, in_dims, x, token, group, rank, how):
    batched = in_dims[0] is not None
    vals, flags = mesh.group_of(group).exchange_batched(
        rank, x.movedim(in_dims[0], 0) if batched else x, batched)
    if not any(flags):
        return combine(vals, how), None
    vals = [v if f else v.expand(info.batch_size, *v.shape)
            for v, f in zip(vals, flags)]
    return combine(vals, how, 1), 0


class TorchBackend:
    name = "torch"

    def __init__(self, device="cpu", group=None, rank: int = 0,
                 token=None):
        self.device = torch.device(device)
        self.group = group        # mesh.ShardGroup of a sharded staged walk
        self.rank = rank
        # a batched walk's tensor that vmap batches (the module docstring)
        self.token = token

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
        return out.index_add(0, ids.clamp(0, n - 1), data)

    @staticmethod
    def _segment_reduce(data, ids, n, fill, how):
        out = torch.full((n,) + tuple(data.shape[1:]), fill, dtype=data.dtype,
                         device=data.device)
        ids = ids.clamp(0, n - 1).long()
        if data.ndim > 1:
            ids = ids.view((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
        # include_self=False: a segment that receives rows reduces over
        # them alone, one that receives none keeps `fill`
        return out.scatter_reduce(0, ids, data, reduce=how,
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
        idx = torch.searchsorted(c, slots, out_int32=True).clamp(0, n - 1)
        return torch.where(slots <= count, idx, 0), count

    @staticmethod
    def barrier(x):
        """Eager torch has no fusion scope to cut: the identity."""
        return x

    # -- mesh collectives over the bound shard group: every shard's value,
    # -- combined in rank order, so every shard gets the same bits
    def _collect(self, x, how: str):
        if self.token is None:
            return combine(self.group.exchange(self.rank, x), how)
        return _collective_op(x, self.token, self.group.handle, self.rank,
                              how)

    def psum(self, x, axis):
        return x if self.group is None else self._collect(x, "psum")

    def pmax(self, x, axis):
        return x if self.group is None else self._collect(x, "pmax")

    def pmin(self, x, axis):
        return x if self.group is None else self._collect(x, "pmin")

    def all_gather(self, x, axis, tiled=False):
        """The shards' `x` concatenated (`tiled`) or stacked along a new
        leading axis, in rank order."""
        if self.group is None:
            return x if tiled else x[None]
        return self._collect(x, "gather" if tiled else "stack")

    def axis_index(self, axis) -> int:
        return self.rank
