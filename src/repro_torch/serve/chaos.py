"""Deterministic chaos harness for `QueryServer`.

Fault injection rides the server's constructor hooks — `compile_hook`
(called by the owning group just before a cold compile) and `exec_hook`
(called once per execution attempt just before the group executes) —
so the server under test is the production class, not a fork.  The
schedule is precomputed from a seed: event i of each hook either fires
or not by table lookup, so a failing tier-1 run replays exactly from its
seed (modulo thread interleaving, which may reorder *which group* draws
event i but never the event stream itself).

Three fault families:

  * compile faults (`ChaosCompileFault`, non-transient) — the owning
    group's compilation raises, exercising the in-flight-dedup recovery
    path (a parked waiter becomes the new owner) and error accounting;
  * transient execution faults (`TransientError`) — injected only on
    attempt 0, so the server's bounded retry always lands: a retried
    transient fault MUST succeed, which the harness asserts;
  * slow executions — a sleep before dispatch, standing in for a
    straggling device, to shake out deadline and close() races.

`run_chaos` is the closed-loop harness: it drives a seeded mixed
workload (two plan shapes × several runtime bindings × rotating
tenants) through a chaos-hooked server, optionally closes mid-window,
and returns a report with the invariants tier-1 asserts — every future
resolved, retried transients succeeded, `ServerStats` balances exactly,
and zero result drift vs the Volcano oracle.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from repro_torch.serve.admission import DeadlineExceeded, Overloaded, TransientError


class ChaosCompileFault(RuntimeError):
    """Injected compile failure (non-transient: the group fails, the next
    group for the key re-owns the compilation)."""


class ChaosSchedule:
    """Seeded fault schedule over hook-call indices.

    `compile_fails` / `exec_faults` / `slows` are sets of call indices
    (per hook, counted independently) at which the fault fires.  Build
    one explicitly for guaranteed-injection tests, or via `seeded()` for
    rate-driven schedules that replay exactly from the seed.
    """

    def __init__(self, *, compile_fails=(), exec_faults=(), slows=(),
                 slow_s: float = 0.01):
        self.compile_fails = frozenset(compile_fails)
        self.exec_faults = frozenset(exec_faults)
        self.slows = frozenset(slows)
        self.slow_s = slow_s
        self.injected = {"compile_fail": 0, "exec_fault": 0, "slow": 0}
        self._lock = threading.Lock()
        self._compile_calls = 0
        self._exec_calls = 0

    @classmethod
    def seeded(cls, seed: int, *, n_events: int = 64,
               compile_fail_rate: float = 0.25, exec_fault_rate: float = 0.2,
               slow_rate: float = 0.2, slow_s: float = 0.01) -> "ChaosSchedule":
        """Draw per-index fault tables from one seed.  Same seed, same
        schedule — the replay property the tier-1 chaos test relies on."""
        rng = np.random.default_rng(seed)
        compile_fails = set(np.flatnonzero(
            rng.random(n_events) < compile_fail_rate).tolist())
        draws = rng.random(n_events)
        exec_faults = set(np.flatnonzero(draws < exec_fault_rate).tolist())
        slows = set(np.flatnonzero(
            (draws >= exec_fault_rate)
            & (draws < exec_fault_rate + slow_rate)).tolist())
        return cls(compile_fails=compile_fails, exec_faults=exec_faults,
                   slows=slows, slow_s=slow_s)

    # -- the two server hooks -------------------------------------------------
    def compile_hook(self, key) -> None:
        with self._lock:
            i = self._compile_calls
            self._compile_calls += 1
            fail = i in self.compile_fails
            if fail:
                self.injected["compile_fail"] += 1
        if fail:
            raise ChaosCompileFault(f"chaos: compile fault at call {i}")

    def exec_hook(self, key, attempt: int) -> None:
        if attempt > 0:
            # retries are never re-injected: the faults are *transient*
            # by construction, so "retried transient faults succeed" is a
            # property the harness can assert deterministically.
            return
        with self._lock:
            i = self._exec_calls
            self._exec_calls += 1
            fault = i in self.exec_faults
            slow = i in self.slows
            if fault:
                self.injected["exec_fault"] += 1
            elif slow:
                self.injected["slow"] += 1
        if fault:
            raise TransientError(f"chaos: transient execution fault "
                                 f"at call {i}")
        if slow:
            time.sleep(self.slow_s)


def run_chaos(db, settings=None, *, seed: int = 0, n_requests: int = 48,
              schedule: Optional[ChaosSchedule] = None,
              close_mid_window: bool = True, check_oracle: bool = True,
              budget: int = 64, max_batch: int = 4, window_s: float = 0.002,
              close_timeout_s: float = 30.0, **server_kw) -> dict:
    """Drive a seeded mixed workload through a chaos-hooked server and
    report the resolution/accounting invariants.

    Returns a dict with the schedule's injected-fault counts, the final
    `ServerStats`, per-outcome future counts, `all_resolved`,
    `balanced` (submitted == completed + errors + rejected + cancelled +
    grace_expired, exactly), and `oracle_drift` (completed results that
    differ from the Volcano oracle under the same bindings — must be 0).
    """
    from repro_torch.core import VolcanoEngine, preset
    from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                                PARAM_QUERIES)
    from repro_torch.serve.query_server import QueryServer

    settings = settings or preset("opt")
    sched = schedule or ChaosSchedule.seeded(seed)
    rng = np.random.default_rng(seed + 1)

    # two plan shapes x a few runtime bindings each: enough key diversity
    # to exercise coalescing, dedup, and degraded-plan entries at once
    shapes = []
    for qname in ("q6", "q3"):
        build, defaults = PARAM_QUERIES[qname]
        alt = dict(defaults, **PARAM_ALT_BINDINGS[qname])
        shapes.append((qname, build, [defaults, alt]))

    srv = QueryServer(db, settings,
                      compile_hook=sched.compile_hook,
                      exec_hook=sched.exec_hook,
                      max_batch=max_batch, window_s=window_s,
                      budget=budget, close_timeout_s=close_timeout_s,
                      **server_kw)
    tenants = ["alpha", "beta", "gamma", None]
    requests = []   # (future, qname, bindings) for resolved-future audit
    rejected_inline = 0
    for i in range(n_requests):
        qname, build, bindings_pool = shapes[int(rng.integers(len(shapes)))]
        bindings = bindings_pool[int(rng.integers(len(bindings_pool)))]
        tenant = tenants[i % len(tenants)]
        priority = 1 if i % 7 == 0 else 0
        try:
            fut = srv.submit(build(), bindings, tenant=tenant,
                             priority=priority)
            requests.append((fut, qname, bindings))
        except Overloaded:
            rejected_inline += 1
        if i % 5 == 4:
            time.sleep(window_s / 2)   # let some windows tick naturally
    if close_mid_window:
        srv.close()     # windows may still be open: the mid-window race
    else:
        srv.drain()
        srv.close()

    outcomes = {"completed": 0, "transient": 0, "compile_fault": 0,
                "deadline": 0, "closed": 0, "other_error": 0}
    unresolved = 0
    oracle_drift = 0
    oracle = VolcanoEngine(db) if check_oracle else None
    expected: dict[tuple, dict] = {}
    for fut, qname, bindings in requests:
        if not fut.done():
            unresolved += 1
            continue
        exc = fut.exception()
        if exc is None:
            outcomes["completed"] += 1
            if oracle is not None:
                okey = (qname, tuple(sorted(bindings.items())))
                if okey not in expected:
                    build = PARAM_QUERIES[qname][0]
                    expected[okey] = oracle.execute(build(), bindings)
                want, got = expected[okey], fut.result()
                same = set(got) == set(want) and all(
                    np.allclose(np.asarray(got[c], dtype=np.float64),
                                np.asarray(want[c], dtype=np.float64),
                                rtol=1e-4, atol=1e-4)
                    for c in got)
                if not same:
                    oracle_drift += 1
        elif isinstance(exc, TransientError):
            outcomes["transient"] += 1
        elif isinstance(exc, ChaosCompileFault):
            outcomes["compile_fault"] += 1
        elif isinstance(exc, DeadlineExceeded):
            outcomes["deadline"] += 1
        elif "closed" in str(exc):
            outcomes["closed"] += 1
        else:
            outcomes["other_error"] += 1

    st = srv.stats
    balanced = (st.submitted == st.completed + st.errors + st.rejected
                + st.cancelled + st.grace_expired)
    return {
        "injected": dict(sched.injected),
        "stats": st,
        "outcomes": outcomes,
        "rejected_inline": rejected_inline,
        "all_resolved": unresolved == 0,
        "balanced": balanced,
        "oracle_drift": oracle_drift,
        # retry accounting: every injected transient exec fault triggers
        # exactly one retry (injection never fires on attempt > 0), and a
        # retried group must succeed — so no future may carry a
        # TransientError.
        "retried_ok": (st.retries == sched.injected["exec_fault"]
                       and outcomes["transient"] == 0),
    }
