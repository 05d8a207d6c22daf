"""A runnable's compaction observations, which `PlanCache` harvests.

Every staged walk reports each compaction point's true valid count
(`core/compile.py`).  `Observations` is the one owner of what the plan
cache's feedback step learns from them, and of the rules that update it:
the run counters, the all-time max per point (and per shard), and the
underuse streak with its window max.  The cache reads it only through
`harvest`, which hands over a consistent copy together with the overflows
since the last harvest, and resets the streak through `reset_streak`.
The Volcano tier's record only counts its runs: it has no points.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np


@dataclasses.dataclass
class Harvest:
    """What `Observations.harvest` hands the plan cache: copies taken
    under the record's lock."""
    overflows: int          # overflowed bindings since the last harvest
    observed: dict          # pid -> all-time max true count
    observed_shard: dict    # pid -> all-time max count of each shard
    under_streak: int
    streak_max: dict        # pid -> max count within the streak


def _max_into(dst: dict, pid: str, c: int) -> None:
    if c > dst.get(pid, -1):
        dst[pid] = c


class Observations:
    """The compaction observations of one runnable, whose planned
    capacities are `point_caps` (point id -> rows; a point missing from
    it is a measure-only probe, counted but never overflowing).  Under a
    lock: a server runs one query from several threads."""

    def __init__(self, point_caps: dict):
        self.point_caps = point_caps
        self._lock = threading.Lock()
        # staged walks run (a batched pass is one), and the bindings whose
        # capacity bucket overflowed and re-ran through the twin
        self.n_executions = 0
        self.n_overflows = 0
        self.observed_max: dict[str, int] = {}
        # per-shard all-time max vectors (shape (n_shards,)): a sharded
        # walk reports every point's count per shard
        self.observed_shard: dict[str, np.ndarray] = {}
        # the current run of consecutive bindings with every point under
        # a quarter of its capacity, and its window max
        self.under_streak = 0
        self.streak_max: dict[str, int] = {}
        self._harvested = 0         # n_overflows at the last harvest

    def record(self, counts: list[dict], executions: int) -> list[int]:
        """Account `executions` staged walks whose bindings' point counts
        are `counts` (one dict a binding, on the host), and return the
        bindings whose capacity bucket overflowed.  A sharded walk's
        `(n_shards,)` count vectors are max-merged into `observed_shard`,
        and the rest keys off the worst shard.  Each binding raises the
        all-time max per point; one with every planned point under a
        quarter of its capacity extends the underuse streak and its
        window max, any other ends it (the shrink signal decays: a
        historical spike must not pin capacity up)."""
        bad = []
        caps = self.point_caps
        with self._lock:
            self.n_executions += executions
            if any(isinstance(c, np.ndarray)
                   for slot in counts[:1] for c in slot.values()):
                counts = [self._worst_shard(slot) for slot in counts]
            for i, slot in enumerate(counts):
                over, under = False, any(pid in caps for pid in slot)
                for pid, c in slot.items():
                    _max_into(self.observed_max, pid, c)
                    cap = caps.get(pid)
                    if cap is None:     # a measure-only probe: counted only
                        continue
                    if c > cap:
                        over = True
                    if 4 * c >= cap:
                        under = False
                if over:
                    bad.append(i)
                if under:
                    self.under_streak += 1
                    for pid, c in slot.items():
                        _max_into(self.streak_max, pid, c)
                else:
                    self.under_streak = 0
                    self.streak_max = {}
            self.n_overflows += len(bad)
        return bad

    def _worst_shard(self, slot: dict) -> dict:
        """Max-merge a binding's per-shard count vectors into
        `observed_shard` (caller holds the lock); its worst shard's
        counts."""
        for pid, v in slot.items():
            old = self.observed_shard.get(pid)
            self.observed_shard[pid] = \
                v.copy() if old is None else np.maximum(old, v)
        return {pid: int(v.max()) for pid, v in slot.items()}

    def merge(self, other: "Observations") -> None:
        """Max-merge `other`'s all-time maxima (the overflow twin's
        measured true counts) into this record: idempotent across
        repeated re-runs."""
        with other._lock:
            seen = dict(other.observed_max)
        with self._lock:
            for pid, c in seen.items():
                _max_into(self.observed_max, pid, c)

    def harvest(self) -> Harvest:
        """A consistent copy of the record, with the overflows since the
        last harvest."""
        with self._lock:
            delta, self._harvested = \
                self.n_overflows - self._harvested, self.n_overflows
            return Harvest(delta, dict(self.observed_max),
                           {pid: v.copy()
                            for pid, v in self.observed_shard.items()},
                           self.under_streak, dict(self.streak_max))

    def reset_streak(self) -> None:
        """End the underuse streak: the plan cache consumed it."""
        with self._lock:
            self.under_streak = 0
            self.streak_max = {}


def read(name: str) -> property:
    """A runnable's read-only attribute for its record's field `name`."""
    return property(lambda self: getattr(self.observations, name),
                    doc=f"`observations.{name}`")
