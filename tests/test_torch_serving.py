"""The port's query server on the CPU at sf 0.01, seed 0: admission
(budget, fairness, priorities), typed deadlines, bounded retry of
transient faults, the degradation ladder down to the interpret rung,
in-flight compile dedup when the owner fails, submit/close races, the
close() grace period, and the seeded chaos harness (every future
resolves, retried transients succeed, `ServerStats` balances, zero drift
from the port's Volcano at `rtol=atol=1e-4`).  Where a sequence is
deterministic, it runs through the reference's server too and the
answers (`test_queries.assert_same`) and statistics must agree.  Every
wait takes a timeout; no assertion rests on how long a sleep lasts."""
import threading
import time

import pytest

from repro.serve.admission import Overloaded as RefOverloaded
from repro_torch.core import preset
from repro_torch.core.passes.pipeline import degrade
from repro_torch.serve.admission import (AdmissionController,
                                         DeadlineExceeded, LatencyHistogram,
                                         Overloaded, RateEMA, TransientError)
from repro_torch.serve.chaos import ChaosSchedule, run_chaos
from test_torch_plan_cache import (assert_matches, one_thread,  # noqa: F401
                                   pdb, run_both, sides)


def _balanced(stats) -> bool:
    return stats.outstanding() == 0


# ---------------------------------------------------------------------------
# admission and telemetry (no database)
# ---------------------------------------------------------------------------

def test_admission_budget_fairness_and_priority():
    adm = AdmissionController(budget=4, tenant_frac=0.5, headroom=1)
    adm.admit("a")
    adm.admit("a")
    with pytest.raises(Overloaded) as ei:       # tenant cap = 2
        adm.admit("a")
    assert ei.value.reason == "fairness" and ei.value.tenant == "a"
    adm.admit("a", priority=1)                  # priority bypasses it
    adm.admit("b")                              # budget full (4)
    with pytest.raises(Overloaded) as ei:
        adm.admit("c")
    assert ei.value.reason == "budget"
    adm.admit("c", priority=1)                  # into the headroom
    with pytest.raises(Overloaded):
        adm.admit(None, priority=1)             # headroom spent
    adm.release("a")
    adm.admit("a", priority=1)
    assert adm.pending() == 5


def test_latency_histogram_and_rate_ema():
    h = LatencyHistogram()
    for v in [0.001] * 90 + [1.0] * 10:
        h.observe(v)
    assert 0.0003 < h.p50() < 0.0015 and 0.3 < h.p99() < 1.5
    assert h.count == 100
    ema = RateEMA()
    for i in range(50):
        ema.observe(0.01 * i)
    assert ema.interval() == pytest.approx(0.01, rel=1e-6)


def test_chaos_schedule_replays_from_seed():
    a, b, c = (ChaosSchedule.seeded(s) for s in (5, 5, 6))
    assert (a.compile_fails, a.exec_faults, a.slows) == \
        (b.compile_fails, b.exec_faults, b.slows)
    assert (a.compile_fails, a.exec_faults, a.slows) != \
        (c.compile_fails, c.exec_faults, c.slows)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_server_answers_and_groups_like_the_reference(sides):
    """24 requests over the six parameterized shapes and two bindings
    each, in one window: the reference's answers, groups and stagings."""
    def seq(s):
        qs = sorted(s.param_queries)
        reqs = [(s.plan(q), s.alt_bindings(q) if i % 2 else s.defaults(q))
                for i, q in enumerate(qs * 4)]
        with s.server(s.db, s.preset("opt"), window_s=3600.0) as srv:
            futs = [srv.submit(p, b) for p, b in reqs]
            srv.flush()
            res = [f.result(timeout=120) for f in futs]
            st = srv.stats
        return res, {"completed": st.completed, "batches": st.batches,
                     "coalesced": st.coalesced,
                     "compiles": srv.cache.stats.compiles}

    obs = run_both(sides, seq)
    assert obs == {"completed": 24, "batches": 6, "coalesced": 24,
                   "compiles": 6, "stagings": 6}


def test_deadline_miss_fails_typed_without_poisoning_group(sides):
    ref, port = sides
    alt = port.alt_bindings("q6")
    with port.server(port.db, preset("opt"), window_s=3600.0,
                     max_batch=64) as srv:
        dead = srv.submit(port.plan("q6"), port.defaults("q6"),
                          timeout_s=0.0)      # expired by dispatch time
        live = srv.submit(port.plan("q6"), alt)
        srv.flush()
        with pytest.raises(DeadlineExceeded):
            dead.result(timeout=60)
        assert_matches(live.result(timeout=60),
                       ref.oracle.execute(ref.plan("q6"),
                                          ref.alt_bindings("q6")))
        srv.drain()
        st = srv.stats
    assert st.deadline_misses == 1 and st.errors == 1 and st.completed == 1
    assert _balanced(st)


def test_transient_fault_retried_and_succeeds(sides):
    ref, port = sides
    calls = []

    def exec_hook(key, attempt):
        calls.append(attempt)
        if len(calls) == 1:
            raise TransientError("injected")

    with port.server(port.db, preset("opt-pallas"), exec_hook=exec_hook,
                     window_s=3600.0, retry_backoff_s=0.001) as srv:
        fut = srv.submit(port.plan("q6"), port.defaults("q6"))
        srv.flush()
        got = fut.result(timeout=120)
        st = srv.stats
    assert_matches(got, ref.oracle.execute(ref.plan("q6"),
                                           ref.defaults("q6")))
    assert calls == [0, 1]
    assert st.retries == 1 and st.errors == 0 and st.completed == 1
    assert _balanced(st)


def test_non_transient_fault_not_retried(sides):
    _ref, port = sides

    def exec_hook(key, attempt):
        raise ValueError("poisoned batch")

    with port.server(port.db, preset("opt"), exec_hook=exec_hook,
                     window_s=3600.0) as srv:
        fut = srv.submit(port.plan("q6"), port.defaults("q6"))
        srv.flush()
        with pytest.raises(ValueError):
            fut.result(timeout=120)
        st = srv.stats
    assert st.retries == 0 and st.errors == 1 and _balanced(st)


def test_degradation_ladder_demotes_to_interpret_then_rejects(sides):
    """Execution gated, so pending grows one request at a time: the
    rungs fire off the pre-admission load (budget 8: smaller windows at
    .5, the interpret rung's settings at .75, then reject), in both
    packages alike; the demoted requests stage their own entry under
    `degrade(settings)` and answer the same."""
    def seq(s):
        gate = threading.Event()
        srv = s.server(s.db, s.preset("opt"),
                       exec_hook=lambda key, attempt: gate.wait(120),
                       window_s=0.001, max_batch=1, max_workers=2,
                       budget=8, shed_batch_load=0.5, shed_plan_load=0.75)
        try:
            futs = [srv.submit(s.plan("q6"), s.defaults("q6"))
                    for _ in range(8)]
            with pytest.raises(Overloaded if s.name == "port"
                               else RefOverloaded):
                srv.submit(s.plan("q6"), s.defaults("q6"))
            gate.set()
            res = [f.result(timeout=120) for f in futs]
            degraded_key = srv.cache.key_for(s.plan("q6"),
                                             srv._degraded_settings,
                                             s.defaults("q6"))
            assert srv.cache.contains(degraded_key)
        finally:
            gate.set()
            srv.close()
        st = srv.stats
        assert _balanced(st)
        return res, {"shed_batch": st.shed_batch, "shed_plan": st.shed_plan,
                     "rejected": st.rejected, "completed": st.completed,
                     "degraded": srv.cache.stats.degraded,
                     "compiles": srv.cache.stats.compiles}

    obs = run_both(sides, seq)
    assert obs == {"shed_batch": 2, "shed_plan": 2, "rejected": 1,
                   "completed": 8, "degraded": 2, "compiles": 2,
                   "stagings": 2}
    _ref, port = sides
    with port.server(port.db, preset("opt-pallas")) as srv:
        assert srv._degraded_settings == degrade(preset("opt-pallas"))


def test_inflight_dedup_owner_compile_failure_hands_off(sides):
    """The owner's compile raises: exactly one parked waiter becomes the
    new owner and stages, and the cache ends warm."""
    ref, port = sides
    started, release = threading.Event(), threading.Event()
    calls = []

    def hook(_key):
        calls.append(None)
        if len(calls) == 1:
            started.set()
            assert release.wait(timeout=120)
            raise RuntimeError("boom: owner compile failed")

    alt = port.alt_bindings("q6")
    before = port.stagings()
    with port.server(port.db, preset("opt"), compile_hook=hook, max_batch=1,
                     window_s=0.001, max_workers=4) as srv:
        f1 = srv.submit(port.plan("q6"), port.defaults("q6"))
        assert started.wait(timeout=120)
        f2 = srv.submit(port.plan("q6"), alt)
        while srv.stats.shared_compiles == 0 and not f2.done():
            time.sleep(0.01)
        release.set()
        with pytest.raises(RuntimeError, match="boom"):
            f1.result(timeout=120)
        got = f2.result(timeout=120)
        hits = srv.cache.stats.hits
        f3 = srv.submit(port.plan("q6"), port.defaults("q6"))
        srv.flush()
        f3.result(timeout=120)
        st, cst = srv.stats, srv.cache.stats
    assert_matches(got, ref.oracle.execute(ref.plan("q6"),
                                           ref.alt_bindings("q6")))
    assert len(calls) == 2 and cst.compiles == 1
    assert port.stagings() - before == 1
    assert st.shared_compiles == 1 and st.errors == 1
    assert cst.hits > hits


def test_submit_racing_close_raises_before_windowing(sides):
    _ref, port = sides
    srv = port.server(port.db, preset("opt"))
    entered, closed = threading.Event(), threading.Event()
    real_prepare = srv.cache._prepare

    def stalled_prepare(*a, **kw):
        entered.set()
        assert closed.wait(timeout=120)
        return real_prepare(*a, **kw)

    srv.cache._prepare = stalled_prepare
    result = {}

    def racer():
        try:
            result["fut"] = srv.submit(port.plan("q6"), port.defaults("q6"))
        except RuntimeError as e:
            result["exc"] = e

    t = threading.Thread(target=racer)
    t.start()
    assert entered.wait(timeout=120)
    srv.close()
    closed.set()
    t.join(timeout=120)
    assert not t.is_alive()
    assert "fut" not in result and "closed" in str(result["exc"])
    assert srv.stats.submitted == 0 and not srv._windows
    assert _balanced(srv.stats)


def test_close_timeout_knob_counts_grace_expired(sides):
    _ref, port = sides
    release = threading.Event()
    srv = port.server(port.db, preset("opt"),
                      exec_hook=lambda key, attempt: release.wait(120),
                      window_s=0.001, max_batch=1, close_timeout_s=0.05)
    fut = srv.submit(port.plan("q6"), port.defaults("q6"))
    srv.flush()
    srv.close()
    assert fut.done()
    with pytest.raises(RuntimeError, match="grace"):
        fut.result(timeout=0)
    assert srv.stats.grace_expired == 1 and srv.stats.errors == 0
    release.set()
    srv._pool.shutdown(wait=True)
    assert srv.stats.completed == 0 and srv.stats.grace_expired == 1
    assert _balanced(srv.stats)


def test_close_joins_every_server_thread(sides):
    _ref, port = sides
    srv = port.server(port.db, preset("opt"), tiered=True, window_s=0.001)
    srv.submit(port.plan("q6"), port.defaults("q6")).result(timeout=120)
    promoter = srv.cache._promoter
    srv.close()
    assert not srv._flusher.is_alive()
    assert not any(t.is_alive() for t in srv._pool._threads)
    assert promoter is not None
    assert not any(t.is_alive() for t in promoter._threads)


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------

def test_chaos_every_future_resolves_and_stats_balance(pdb):
    sched = ChaosSchedule(compile_fails={0}, exec_faults={1, 4},
                          slows={2, 6}, slow_s=0.005)
    report = run_chaos(pdb, preset("opt-pallas"), seed=7, n_requests=32,
                       schedule=sched, close_mid_window=True, max_batch=4,
                       window_s=0.002, budget=64, device="cpu")
    st = report["stats"]
    assert report["all_resolved"] and report["balanced"]
    assert st.outstanding() == 0 and report["oracle_drift"] == 0
    assert report["retried_ok"], (st.retries, report["injected"],
                                  report["outcomes"])
    assert report["injected"]["compile_fail"] >= 1
    assert report["injected"]["exec_fault"] >= 1
    assert report["injected"]["slow"] >= 1
    assert report["outcomes"]["compile_fault"] >= 1


def test_chaos_seeded_schedule_run(pdb):
    report = run_chaos(pdb, seed=11, n_requests=24, close_mid_window=False,
                       max_batch=4, device="cpu")
    assert report["all_resolved"] and report["balanced"]
    assert report["oracle_drift"] == 0 and report["retried_ok"]
