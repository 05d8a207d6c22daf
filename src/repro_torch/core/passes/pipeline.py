"""The SC-analogue transformation pipeline (paper §2.2, Fig 5b).

Each optimization is a `Pass`: a black-box plan→plan transformer with no
dependence on other passes or on the engine base code.  `build_pipeline`
assembles the explicit, settings-driven pipeline exactly as Fig 5b does —
passes can be turned on/off independently and reordered, and constant
folding / simplification runs after each domain-specific pass (the paper's
``ParamPromDCEAndPartiallyEvaluate`` interleaving).

Engine-configuration ladder (paper Table III) is expressed as `Settings`
presets at the bottom of this file.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

from repro_torch.core import ir


@dataclasses.dataclass
class Settings:
    # --- execution style -----------------------------------------------------
    # 'volcano'  : interpreted operator-at-a-time numpy engine (DBX analogue)
    # 'compiled' : whole-query staged program (LegoBase analogue)
    engine: str = "compiled"
    # operator fusion across the whole query; False inserts optimization
    # barriers between operators ≈ template-expansion compilers that codegen
    # operators independently (HyPer-style scope limit, paper §1/Fig 2).
    fusion: bool = True
    # --- domain-specific optimizations (paper §3) ----------------------------
    partitioning: bool = True       # §3.2.1 PK/FK partitioned joins
    dense_agg: bool = True          # §3.2.2 hash-map lowering to arrays
    date_index: bool = True         # §3.2.3 date indices
    string_dict: bool = True        # §3.4 string dictionaries
    column_pruning: bool = True     # §3.6.1 unused-attribute removal
    cse: bool = True                # §3.6 CSE / partial evaluation
    hoist: bool = True              # §3.5 domain-specific code motion
    layout: str = "column"          # §3.3: 'column' (SoA) or 'row' (AoS)
    # --- beyond-paper ---------------------------------------------------------
    # sharded execution over a 1-D device mesh (passes/sharding.py):
    # 1 = single device (no mesh), 0 = auto (every visible device),
    # n>1 = exactly n.  The resolved count joins the plan-cache key — the
    # same plan at a different mesh shape is a different compiled program
    # with different per-shard capacities.
    shards: int = 1
    use_pallas: bool = False        # fuse hot paths into Pallas TPU kernels
    # Pallas kernel execution mode: None = auto (interpret only when no
    # TPU/GPU backend is present), True/False = forced.
    pallas_interpret: "bool | None" = None
    dense_agg_cap: int = 1 << 22    # max dense key domain (worst-case alloc)
    # --- selection-vector compaction (passes/compaction.py) -------------------
    compaction: bool = True         # compact masked frames at planned points
    compact_margin: float = 2.0     # capacity headroom over estimated rows
    compact_min_rows: int = 512     # never compact frames smaller than this
    # adaptive capacity feedback (plan_cache.py): observed per-point valid
    # counts drive re-planning — after `compact_replan_after` overflows the
    # entry re-plans with capacities derived from observed max counts, and
    # after `compact_shrink_after` consecutive large underuses (observed
    # < capacity/4 at every point) capacities shrink to the measured
    # bucket.  Each transition costs at most one retrace per direction.
    compact_feedback: bool = True   # on at the `opt` rung (with compaction)
    compact_replan_after: int = 3   # overflows before re-planning up
    compact_shrink_after: int = 4   # consecutive underuses before shrinking
    # internal (set by CompiledQuery for the overflow twin, never by
    # presets): plant measure-only points (capacity 0, frame untouched)
    # at every candidate site instead of real compaction, so a fallback
    # execution reports every site's TRUE count — a count measured below
    # an overflowed point is truncated, and re-planning from truncated
    # counts converges one layer per k overflows instead of in one step.
    compact_measure_only: bool = False
    # --- static analysis / verification (core/analysis) -----------------------
    # run the inter-pass verifier on the input plan and after every pass:
    # a well-formedness violation raises PlanInvariantError naming the
    # offending pass (pass bisection for free).  On by default — the check
    # is a few plan walks per optimize, which only runs at compile time;
    # latency-critical serving paths that re-optimize per plan shape can
    # switch it off (dataclasses.replace(settings, verify_passes=False)).
    verify_passes: bool = True


class Pass(Protocol):
    name: str

    def run(self, plan: ir.Plan, db, settings: Settings) -> ir.Plan: ...


def build_pipeline(settings: Settings, bindings: dict | None = None,
                   est_params: dict | None = None,
                   observed: dict | None = None) -> list[Pass]:
    from repro_torch.core.passes.column_pruning import ColumnPruning
    from repro_torch.core.passes.compaction import Compaction
    from repro_torch.core.passes.cse_dce import FoldAndSimplify
    from repro_torch.core.passes.date_index import DateIndex
    from repro_torch.core.passes.fusion import SelectFusion
    from repro_torch.core.passes.hashmap_lowering import HashMapLowering
    from repro_torch.core.passes.param_binding import ParamBinding
    from repro_torch.core.passes.partitioning import Partitioning
    from repro_torch.core.passes.string_dict import StringDictionary

    pipeline: list[Pass] = []
    if bindings:
        # resolve Params first so every downstream pass sees plain literals
        # (full specialization); without bindings the plan stays
        # param-residual and numeric Params become staged-program inputs.
        pipeline.append(ParamBinding(bindings))
    pipeline.append(SelectFusion())           # always: canonicalizes Select chains
    if settings.cse:
        pipeline.append(FoldAndSimplify())
    if settings.date_index:
        pipeline.append(DateIndex())
    if settings.dense_agg:
        pipeline.append(HashMapLowering())
    if settings.partitioning:
        pipeline.append(Partitioning())
    if settings.string_dict:
        pipeline.append(StringDictionary())
    if settings.cse:
        pipeline.append(FoldAndSimplify())
    if settings.shards != 1:
        # after the join/agg strategies are fixed (it keys off them) and
        # before ColumnPruning (Exchange nodes are schema-transparent) /
        # Compaction (capacities must be planned per shard).
        from repro_torch.core.passes.sharding import Sharding

        pipeline.append(Sharding())
    if settings.column_pruning:
        pipeline.append(ColumnPruning())      # prune post-rewrite
    if settings.compaction:
        # last: capacities are planned against the final operator strategies
        # (join lowering, dense aggs, date slices) chosen above.
        # `est_params` are the first-seen runtime bindings (initial
        # estimates for Param-bounded predicates); `observed` maps
        # candidate point ids to measured valid counts and overrides the
        # static estimates on re-plan (adaptive capacity feedback).
        pipeline.append(Compaction(est_params=est_params, observed=observed))
    return pipeline


def optimize(plan: ir.Plan, db, settings: Settings,
             bindings: dict | None = None,
             est_params: dict | None = None,
             observed: dict | None = None,
             device=None) -> ir.Plan:
    """Run the pass pipeline.  `device` is where the plan will run:
    `settings.shards` resolves once, here, against its visible slots
    (`mesh.resolve_shards`; None: the card when there is one, else the
    CPU), and every pass reads the resolved count."""
    if settings.shards != 1:
        from repro_torch.core.mesh import resolve_shards

        settings = dataclasses.replace(
            settings, shards=resolve_shards(settings, device))
    pipeline = build_pipeline(settings, bindings, est_params, observed)
    if not settings.verify_passes:
        for p in pipeline:
            plan = p.run(plan, db, settings)
        return plan
    from repro_torch.core.analysis.verify import verify_plan

    # verify the hand-written input too (pass_name 'input'), then after
    # each pass; final-only rules (e.g. key-pack) run after the last one
    verify_plan(plan, db, settings, pass_name="input", final=False)
    last = len(pipeline) - 1
    for i, p in enumerate(pipeline):
        plan = p.run(plan, db, settings)
        verify_plan(plan, db, settings, pass_name=p.name, final=(i == last))
    return plan


# ---------------------------------------------------------------------------
# Engine ladder presets (paper Table III)
# ---------------------------------------------------------------------------

def preset(name: str) -> Settings:
    if name == "dbx":            # commercial in-memory DBMS, no compilation
        return Settings(engine="volcano", fusion=False, partitioning=False,
                        dense_agg=False, date_index=False, string_dict=False,
                        column_pruning=False, cse=False, hoist=False,
                        compaction=False)
    if name == "naive":          # LegoBase(Naive): inlining/push only
        return Settings(engine="compiled", fusion=True, partitioning=False,
                        dense_agg=False, date_index=False, string_dict=False,
                        column_pruning=False, cse=False, hoist=False,
                        compaction=False)
    if name == "template":       # HyPer-style: per-operator codegen scope
        return Settings(engine="compiled", fusion=False, partitioning=True,
                        dense_agg=False, date_index=False, string_dict=False,
                        column_pruning=False, cse=False, hoist=False,
                        compaction=False)
    if name == "tpch":           # LegoBase(TPC-H/C): + partitioning
        return Settings(engine="compiled", fusion=True, partitioning=True,
                        dense_agg=False, date_index=False, string_dict=False,
                        column_pruning=False, cse=False, hoist=False,
                        compaction=False)
    if name == "strdict":        # LegoBase(StrDict/C)
        return Settings(engine="compiled", fusion=True, partitioning=True,
                        dense_agg=False, date_index=False, string_dict=True,
                        column_pruning=False, cse=False, hoist=False,
                        compaction=False)
    if name == "opt":            # LegoBase(Opt/C): everything
        return Settings()
    if name == "opt-pallas":     # beyond paper: + Pallas fused kernels
        return Settings(use_pallas=True)
    if name == "opt-shard":      # beyond paper: + mesh-sharded execution
        return Settings(shards=0)
    if name == "mask-only":      # serving degradation rung: see degrade()
        return degrade(Settings())
    raise KeyError(name)


def degrade(settings: Settings) -> Settings:
    """The serving degradation rung for `settings` (QueryServer's ladder,
    docs §10): keep every semantic rewrite but drop the latency-tuning
    machinery whose compile cost is unaffordable under overload —
    compaction (capacity planning + gather points), its adaptive
    feedback (re-plans retrace), and the per-optimize pass verifier.
    Frames stay mask-only, so results are bit-identical; only the
    padded-row waste changes.  Because `Settings` joins the plan-cache
    key, degraded entries coexist with full entries for the same plan."""
    return dataclasses.replace(settings, compaction=False,
                               compact_feedback=False, verify_passes=False)


LADDER = ["dbx", "naive", "tpch", "strdict", "opt"]
