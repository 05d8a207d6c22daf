"""The staged query compiler, on torch (see the `repro` package's `core`
for the reference):

  expr.py / ir.py     — expression + plan IR (incl. Param query parameters)
  passes/             — the optimization-pass library (paper §3)
  analysis/           — schema/property inference and the pass verifier
  operators/          — physical operators: stage(node, ctx) -> Frame
  backend.py          — the torch ops whose semantics the operators rely
                        on, and the mesh collectives
  mesh.py             — the 1-D data mesh of sharded execution: one
                        thread per shard, collectives at a rendezvous
  compile.py          — staging: one resident program per query (`run`,
                        bind-many `run_many`, `compile` builds its kernels)
  plan_cache.py       — runtime: compile-once / bind-many plan cache,
                        `execute_many` over plan-key groups; tier-aware
                        cold serving + background promotion
  volcano.py          — the interpreted numpy engine (the dbx rung, the
                        port's own oracle, the tier ladder's bottom rung)
  tiering.py          — the execution-tier ladder (oracle -> interpret
                        -> compiled -> opt-pallas) + Runnable protocol
  persist.py          — warm-state persistence (feedback store + warm
                        metadata; a lasting kernel build directory)
"""
from repro_torch.core.compile import CompiledQuery, CompiledQueryBatch
from repro_torch.core.passes.pipeline import (LADDER, Settings, degrade,
                                              optimize, preset)
from repro_torch.core.persist import enable_compilation_cache
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.tiering import (COMPILED, INTERPRET, OPT_PALLAS,
                                      ORACLE, TIERS, ExecutionTier, Runnable,
                                      TierLadder)
from repro_torch.core.volcano import OracleQuery, VolcanoEngine

__all__ = ["CompiledQuery", "CompiledQueryBatch", "PlanCache",
           "VolcanoEngine", "OracleQuery", "Settings", "optimize", "preset",
           "degrade", "LADDER", "ExecutionTier", "TierLadder", "Runnable",
           "TIERS", "ORACLE", "INTERPRET", "COMPILED", "OPT_PALLAS",
           "enable_compilation_cache"]
