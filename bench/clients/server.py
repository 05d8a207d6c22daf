"""A report service: the port's `QueryServer` over one shared plan cache,
with the configuration's `server` settings (the rest at the server's
defaults).  Each request is one `submit(plan, bindings)` of its query's
`PARAM_QUERIES` template, every binding sent, the strings too; the
server binds, coalesces and executes, and answers through the future.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import compile as compile_mod
from repro_torch.core.passes.pipeline import preset
from repro_torch.relational.queries import PARAM_QUERIES
from repro_torch.serve.query_server import QueryServer

# the server's counters the benchmark reads (`ServerStats` fields)
COUNTERS = ("submitted", "completed", "errors", "rejected", "batches",
            "coalesced", "shed_batch", "shed_plan", "deadline_misses",
            "replans", "shrinks", "retries")


class Client:
    asynchronous = True

    def __init__(self, config: dict, db, traffic: dict, generator, device):
        settings = dataclasses.replace(
            preset(config["preset"]), **config.get("settings", {}))
        self.server = QueryServer(db, settings, device=device,
                                  **config.get("server", {}))
        self.plans = {q: PARAM_QUERIES[q][0]()
                      for q in generator.queries(traffic)}
        self.defaults = {q: dict(PARAM_QUERIES[q][1], **generator.structural(
            traffic, q)) for q in self.plans}
        # the most requests one window can hold under this traffic: a
        # closed loop never has more in flight than it keeps outstanding
        reach = {"stream": 1, "closed": traffic.get("outstanding", 1)}
        self.batch = min(self.server.max_batch,
                         int(reach.get(traffic["loop"],
                                       self.server.max_batch)))

    def stage(self) -> None:
        """Warm each template's shapes through the server: one request
        alone (the scalar walk), and where the traffic can fill a window
        with a batched pass's worth, a full window of them (one batched
        pass).  That stages the plan and builds every kernel library the
        traffic's walks reach, and no other."""
        for q, plan in self.plans.items():
            d = self.defaults[q]
            self.server.submit(plan, d).result()
            if self.batch >= compile_mod.BATCH_MIN:
                futs = [self.server.submit(plan, d)
                        for _ in range(self.batch)]
                for f in futs:
                    f.result()

    def submit(self, query: str, bindings, done) -> None:
        """Send one request; `done(answer, error)` runs when it resolves."""
        try:
            fut = self.server.submit(self.plans[query], bindings)
        except Exception as e:         # refused at the door
            done(None, e)
            return

        def resolved(f):
            e = f.exception()
            done(None if e is not None else f.result(), e)

        fut.add_done_callback(resolved)

    def counters(self) -> dict:
        got = {k: getattr(self.server.stats, k) for k in COUNTERS}
        got["stagings"] = compile_mod.STAGINGS
        return got

    def close(self) -> None:
        self.server.close()

