"""Hash-map lowering (paper §3.2.2).

Generic hash aggregation is specialized using schema + statistics knowledge
collected at load time:

  * no group key                     -> 'scalar' (the paper's "single,
    statically-known key" case, e.g. Q6's global aggregate): accumulators
    become scalar registers;
  * all group-key domains statically known and small -> 'dense': the hash
    map becomes a pre-allocated native array indexed by a mixed-radix
    composite of the key codes (the paper's "convert the hash map to a
    native array", with the pre-allocation sized by worst-case analysis and
    the initialization hoisted off the critical path — in XLA the
    accumulator is a statically-shaped zero buffer);
  * otherwise                        -> 'generic' sort-based grouping.

Domains come from the analysis layer's per-column `ColInfo.domain` (CAT
dictionary sizes, dense PK/FK ranges, integer stats) or explicit
statistics hints (`Agg.domain_hints`, §3.5.2); one `analyze()` pass serves
every Agg in the plan.
"""
from __future__ import annotations

from repro_torch.core import ir
from repro_torch.core.analysis import analyze
from repro_torch.relational.loader import Database


class HashMapLowering:
    name = "HashMapLowering"

    def run(self, plan: ir.Plan, db: Database, settings) -> ir.Plan:
        a = analyze(plan, db)
        for node in ir.walk(plan):
            if not isinstance(node, ir.Agg) or node.strategy != "generic":
                continue
            if not node.group_by:
                node.strategy = "scalar"
                continue
            child = a.schema(node.child)
            # Without string dictionaries a CAT key has no integer code
            # domain — the dictionary IS the domain knowledge (§3.4/§3.2.2).
            if not settings.string_dict and any(
                    ci is not None and ci.dtype == "code"
                    for ci in (child.get(g) for g in node.group_by)):
                continue
            domains = []
            for g in node.group_by:
                d = node.domain_hints.get(g)
                if d is None:
                    ci = child.get(g)
                    d = ci.domain if ci is not None else None
                domains.append(d)
            if all(d is not None for d in domains):
                total = 1
                for d in domains:
                    total *= d
                if total <= settings.dense_agg_cap:
                    node.strategy = "dense"
                    node.domains = [int(d) for d in domains]
        return plan
