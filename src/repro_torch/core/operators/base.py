"""Shared staging context + frame types for the physical-operator layer.

Each operator module in `repro_torch.core.operators` exposes

    stage(node, ctx, defer=False) -> Frame

and is a pure function of the plan node and the `StageCtx` — no operator
knows about any other.  The same torch code runs twice per compilation:
on 8-row CPU samples (the collection walk, registering the staged
program's exact input set) and on the resident inputs (the staged walk,
eager, on the query's device).  `StageCtx.staged` is what tells the two
apart: the hand kernels are reached only in the staged walk.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.expr import EvalEnv, Param

F32BIG = 3.0e38


@dataclasses.dataclass
class Binding:
    arr: Any
    kind: str                     # num | codes | chars | words | wordchars
    table: Optional[object] = None  # source Table (for vocab decode)
    col: Optional[str] = None


@dataclasses.dataclass
class Frame:
    cols: dict[str, Binding]
    mask: Any = None              # bool tensor or None (all valid)
    pending: list = dataclasses.field(default_factory=list)
    # set by the Compact operator: this frame's physical row count is a
    # planner-assigned compaction capacity (valid rows are dense-packed at
    # the front; `mask` marks the pad slots).  Informational only.
    capacity: Any = None
    # set by a translate-Compact (ir.Compact.translate): the CSR key→slot
    # vector over the PRE-compaction row domain — slot_of[row] is the
    # row's position in this compacted frame, -1 when the row was
    # mask-invalid.  pk_gather consumes it to probe a compacted build
    # side by key value.
    slot_of: Any = None
    # partition root table when this frame's rows are physically sharded
    # over the mesh's data axis (see loader.ShardPlan); None = replicated.
    # Set by the Scan operator from the Sharding pass's annotation and
    # threaded through every operator identically in both walks — it is
    # what tells a join to rebase positional indices, an aggregation to
    # psum its partials, and an Exchange to all-gather.
    part: Optional[str] = None


def frame_nrows(f: Frame) -> int:
    b = next(iter(f.cols.values()))
    return b.arr.shape[0]


def and_masks(m1, m2):
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    return m1 & m2


@dataclasses.dataclass
class StageCtx:
    """Everything an operator needs to stage itself.

    `input(key, make)` registers/fetches a named input of the staged
    program: during the collection walk it materializes `make()` and
    records it; during the staged walk it returns the resident tensor.
    `params` holds the current runtime parameter bindings (registered as
    inputs `param/<name>` so re-binding never re-stages).  `device` is
    where the walk's tensors live; `staged` is False on the collection
    walk, where no hand kernel is launched.
    """
    db: Any
    settings: Any
    backend: Any
    input: Callable[[str, Callable], Any]
    params: dict = dataclasses.field(default_factory=dict)
    device: Any = "cpu"
    staged: bool = False
    # per-compaction-point TRUE valid counts (int32 scalars), keyed by the
    # point's id: the staged program's third output.  A count above the
    # point's capacity is the overflow signal.
    compact_counts: dict = dataclasses.field(default_factory=dict)
    # sharded execution (Settings.shards > 1): `axis` is the mesh axis the
    # staged walk runs over, once per shard (None single-device — the
    # collection walk gets the axis too, where the backend's collectives
    # are identities), `n_shards` its size, `shard_plan` the loader's
    # co-partitioning layout.  `sharded_keys` collects the input keys
    # whose arrays are partitioned over the axis — compile.py splits
    # them into per-shard blocks.
    axis: Optional[str] = None
    n_shards: int = 1
    shard_plan: Any = None
    sharded_keys: set = dataclasses.field(default_factory=set)

    @property
    def use_kernels(self) -> bool:
        """The hand-kernel rung: `Settings.use_pallas`, staged walk only."""
        return bool(self.settings.use_pallas) and self.staged

    def stage(self, plan, defer: bool = False) -> Frame:
        from repro_torch.core import operators

        return operators.stage(plan, self, defer)

    def env(self, frame: Frame) -> "FrameEnv":
        return FrameEnv(frame, self)

    def ones(self, n: int):
        return torch.ones((n,), dtype=torch.bool, device=self.device)

    def arange(self, n: int):
        return torch.arange(n, dtype=torch.int32, device=self.device)

    def param(self, p: Param):
        """A runtime parameter as a Python scalar of its dtype: torch
        combines it with tensors on any device, and a kernel takes it as a
        plain scalar argument without a device round trip.  In the
        batched walk (`CompiledQuery.run_many`, under `torch.func.vmap`)
        the bound input is a 0-d tensor that vmap batches over the
        bindings, and it stays one: a host scalar cannot vary by
        binding."""
        if p.dtype == "str":
            raise TypeError(f"string parameter {p.name!r} must be bound at "
                            "compile time (it has no runtime representation)")
        if p.name not in self.params:
            raise KeyError(f"unbound query parameter {p.name!r}")
        v = self.input(
            f"param/{p.name}",
            lambda: np.asarray(self.params[p.name], dtype=p.dtype))
        if getattr(v, "ndim", 0) != 0:
            raise TypeError(f"param/{p.name} must reach operators as a "
                            f"scalar (got shape {v.shape})")
        if isinstance(v, torch.Tensor):
            return v
        return v.item() if hasattr(v, "item") else v

    def note_compact(self, point_id: str, count) -> None:
        """Register a compaction point's true valid count.  The count is
        the total over the full mask, so it is exact even when it exceeds
        the point's capacity — that excess IS the overflow signal."""
        if point_id in self.compact_counts:
            raise ValueError(f"compaction point {point_id!r} staged twice")
        self.compact_counts[point_id] = count


class FrameEnv(EvalEnv):
    """Expression environment over a staged Frame."""

    def __init__(self, frame: Frame, ctx: StageCtx):
        super().__init__(torch, ctx.settings.cse)
        self.frame = frame
        self.ctx = ctx

    def _b(self, name: str) -> Binding:
        return self.frame.cols[name]

    def get_num(self, name):
        b = self._b(name)
        assert b.kind in ("num", "codes"), f"{name} is {b.kind}, not numeric"
        return b.arr

    def get_codes(self, name):
        b = self._b(name)
        assert b.kind == "codes", f"{name} has no dictionary codes ({b.kind})"
        return b.arr

    def get_chars(self, name):
        b = self._b(name)
        assert b.kind == "chars", f"{name} has no char matrix ({b.kind})"
        return b.arr

    def get_words(self, name):
        b = self._b(name)
        assert b.kind == "words", f"{name} has no word codes ({b.kind})"
        return b.arr

    def get_word_chars(self, name):
        b = self._b(name)
        assert b.kind == "wordchars", f"{name} has no text chars ({b.kind})"
        return b.arr

    def get_param(self, p: Param):
        # runtime params are inputs of the staged program, not env literals
        return self.ctx.param(p)
