"""The engine as a library, LegoBase's own use: each plan the traffic
sends is built once as `CompiledQuery(plan, db, settings)` and then
`run(params)` is called for each request, in the caller's thread.

A query the traffic gives parameters runs its `PARAM_QUERIES` template:
its compile-time parameters (strings, the row limit) are bound once, at
the values the traffic holds constant, and the numeric ones are bound at
each `run`.  Any other query runs its literal plan from `QUERIES`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import CompiledQuery
from repro_torch.core import compile as compile_mod
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.core.passes.pipeline import preset
from repro_torch.relational.queries import PARAM_QUERIES, QUERIES


class Client:
    asynchronous = False

    def __init__(self, config: dict, db, traffic: dict, generator, device):
        self.settings = dataclasses.replace(
            preset(config["preset"]), **config.get("settings", {}))
        self.db, self.device = db, device
        self.plans: dict = {}
        for q in generator.queries(traffic):
            if q in traffic.get("params", {}):
                build, defaults = PARAM_QUERIES[q]
                plan = build()
                fixed = generator.structural(traffic, q)
                spec = plan_params(plan)
                baked = {n: fixed.get(n, defaults[n]) for n, i in spec.items()
                         if i.structural}
                runtime = {n: defaults[n] for n, i in spec.items()
                           if not i.structural}
                self.plans[q] = (bind_plan(plan, baked), baked, runtime)
            else:
                self.plans[q] = (QUERIES[q](), {}, {})
        self.compiled: dict = {}

    def stage(self) -> None:
        """Build every plan and every kernel library its walk reaches."""
        for q, (plan, _baked, runtime) in self.plans.items():
            cq = CompiledQuery(plan, self.db, self.settings, params=runtime,
                               device=self.device)
            cq.compile()
            self.compiled[q] = cq

    def submit(self, query: str, bindings, done) -> None:
        """Run one request now; `done(answer, error)` when it has answered."""
        cq = self.compiled[query]
        baked = self.plans[query][1]
        try:
            params = None if bindings is None else {
                k: v for k, v in bindings.items() if k not in baked}
            answer = cq.run(params)
        except Exception as e:        # the request fails, the run goes on
            done(None, e)
            return
        done(answer, None)

    def counters(self) -> dict:
        return {"stagings": compile_mod.STAGINGS,
                "executions": sum(c.n_executions
                                  for c in self.compiled.values()),
                "overflows": sum(c.n_overflows
                                 for c in self.compiled.values())}

    def close(self) -> None:
        self.compiled.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
