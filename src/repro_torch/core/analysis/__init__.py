"""Static analysis over the plan IR.

Three parts:

  * schema & property inference (`schema.py`, `properties.py`): one
    bottom-up dataflow pass computing per-node output schemas (dtype
    families + base-column provenance + domain bounds) and derived
    properties (cardinality upper bounds, sortedness, date clustering,
    positional parent alignment), memoized behind `analyze(plan, db)`;
  * the inter-pass verifier (`verify.py`): a rule registry over the
    analysis results, run after every pass when `Settings.verify_passes`
    is on — violations raise `PlanInvariantError` naming the pass;
  * the plan fuzzer (`fuzz.py`, imported on demand — it pulls in the
    compile stack): seeded random TPC-H plans driven through every preset
    ladder rung against the port's Volcano engine.
"""
from repro_torch.core.analysis.properties import (Analysis, NodeInfo, analyze,
                                            composite_pack_bound)
from repro_torch.core.analysis.schema import (ColInfo, SchemaError, base_colinfo,
                                        expr_dtype, schema_of)
from repro_torch.core.analysis.verify import (RULES, PlanInvariantError, Violation,
                                        check_plan, rule, verify_plan)

__all__ = [
    "Analysis",
    "NodeInfo",
    "analyze",
    "composite_pack_bound",
    "ColInfo",
    "SchemaError",
    "base_colinfo",
    "expr_dtype",
    "schema_of",
    "RULES",
    "PlanInvariantError",
    "Violation",
    "check_plan",
    "rule",
    "verify_plan",
]
