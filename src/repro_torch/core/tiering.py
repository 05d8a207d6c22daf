"""First-class execution tiers: one ladder from interpreter to kernels.

Before this module, "how should this plan execute" was answered by three
uncoordinated mechanisms — `Settings.engine` ('volcano'/'compiled'), the
mask-only `pipeline.degrade` rung the server used for load shedding, and
the `opt-pallas` kernel rung — each with its own call-site convention.
The ladder makes the choice a first-class, ordered value:

    oracle (0)     — the interpreted Volcano engine (`volcano.OracleQuery`).
                     Zero compile cost: ready the moment the plan exists.
    interpret (1)  — the staged program under `pipeline.degrade` settings:
                     mask-only frames, no compaction machinery, no pass
                     verifier.  Same results, cheapest compile.
    compiled (2)   — the full staged program (`CompiledQuery`) under the
                     caller's settings, kernels off.
    opt-pallas (3) — the same with the hand-written CUDA kernels (the
                     reference's Pallas rung), built at `compile()`.

Every tier satisfies the same `Runnable` contract (`run`, `run_many`, the
staged-outputs observation surface), so any tier is substitutable at the
call site.  Two subsystems walk the SAME ladder in opposite directions:

  * `PlanCache` *climbs* it — a cold request is served by the best ready
    tier (the oracle, instantly) while a bounded background thread
    compiles the target tier and hot-swaps the entry (docs §11);
  * `QueryServer` *descends* it — admission overload demotes new windows
    to a lower tier's settings instead of maintaining a private
    mask-only path (docs §10's ladder, re-expressed).

Tiers are value objects; `TierLadder` binds them to a concrete target
`Settings` and answers "what settings realize tier t for this target".
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.observations import Observations
from repro_torch.core.passes.pipeline import Settings, degrade


@dataclasses.dataclass(frozen=True, order=True)
class ExecutionTier:
    """One rung: totally ordered by rank (higher = more compiled)."""
    rank: int
    name: str

    def __repr__(self) -> str:
        return f"ExecutionTier({self.name!r}, rank={self.rank})"


ORACLE = ExecutionTier(0, "oracle")
INTERPRET = ExecutionTier(1, "interpret")
COMPILED = ExecutionTier(2, "compiled")
OPT_PALLAS = ExecutionTier(3, "opt-pallas")

TIERS = (ORACLE, INTERPRET, COMPILED, OPT_PALLAS)
_BY_NAME = {t.name: t for t in TIERS}


def tier(name: str) -> ExecutionTier:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown execution tier {name!r}; "
                       f"ladder is {[t.name for t in TIERS]}") from None


@runtime_checkable
class Runnable(Protocol):
    """What every tier's executable exposes (the CompiledQuery contract).

    `run(params)` executes one binding; `run_many(bindings_list)` executes
    N bindings positionally.  Binding validation is identical across
    tiers: a dict must name exactly the plan's runtime parameters, and
    None means the construction-time defaults.  The observation surface
    (`compaction_points`, `point_caps`, `translate_points` and the
    `observations` record that `PlanCache` harvests) exists on every tier
    so `PlanCache`'s accounting and feedback harvesting never
    special-case the tier they run against — tiers without compaction
    machinery report zero points and are skipped naturally."""

    tier_name: str
    param_spec: dict
    compaction_points: int
    observations: Observations

    def run(self, params: Optional[dict] = None) -> dict[str, np.ndarray]:
        ...

    def run_many(self, bindings_list) -> list[dict[str, np.ndarray]]:
        ...


class TierLadder:
    """The ladder bound to a concrete target `Settings`.

    The target tier is read off the settings: `opt-pallas` when
    `use_pallas`, else `compiled` (a 'volcano' engine setting degenerates
    the ladder to the oracle alone).  `settings_for(t)` answers what
    settings realize tier `t` while preserving every semantic choice of
    the target — the interpret tier is exactly `pipeline.degrade(target)`
    (the server's historical mask-only rung), so results are
    bit-identical at every rung and only the latency machinery differs.
    """

    def __init__(self, settings: Settings):
        self.base = settings
        if settings.engine != "compiled":
            self.target = ORACLE
        elif settings.use_pallas:
            self.target = OPT_PALLAS
        else:
            self.target = COMPILED

    def tiers(self) -> list[ExecutionTier]:
        """Rungs of this ladder, bottom (cheapest to ready) to target."""
        return [t for t in TIERS if t.rank <= self.target.rank]

    def settings_for(self, t: ExecutionTier) -> Settings:
        if t.rank > self.target.rank:
            raise ValueError(f"{t.name} is above this ladder's target "
                             f"({self.target.name})")
        if t is ORACLE:
            return dataclasses.replace(self.base, engine="volcano")
        if t is INTERPRET:
            return degrade(self.base)
        if t is COMPILED and self.target is OPT_PALLAS:
            return dataclasses.replace(self.base, use_pallas=False)
        return self.base

    def demote(self, t: ExecutionTier, n: int = 1) -> ExecutionTier:
        """`n` rungs below `t`, clamped to the ladder's bottom."""
        return TIERS[max(t.rank - n, 0)]

    def promotion_path(self, ready: ExecutionTier,
                       through: bool = False) -> list[ExecutionTier]:
        """Tiers a background promoter should build, in order, starting
        above `ready`.  Default: straight to the target (one compile);
        `through=True` climbs rung by rung (an interpret-tier program
        becomes servable before the full compile lands — cheaper partial
        promotion at the cost of one extra compile)."""
        if through:
            return [t for t in self.tiers()
                    if ready.rank < t.rank <= self.target.rank
                    and t is not ORACLE]
        return [self.target] if ready.rank < self.target.rank else []
