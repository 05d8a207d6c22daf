"""The compaction feedback loop in the port, on the CPU at sf 0.01, seed
0, step for step against the reference: the same request sequence plants
the same capacities, observes the same true counts, overflows, re-plans
and shrinks at the same requests, and after every step the entry the
cache serves has the reference's `point_caps`.  Answers are held to the
reference's (`test_queries.assert_same`: exact on ints, rtol 2e-3 on
floats).  Beside it, the overflow twin: a hand-planted point too small
for its rows falls back, is staged once, and reports the true count."""
import dataclasses

import pytest

from repro_torch.core.passes.compaction import observed_bucket
from repro_torch.relational.schema import days
from test_torch_plan_cache import (one_thread, pdb,  # noqa: F401
                                   run_both, sides, stats_of)

# q3_param bindings: SELECTIVE leaves few lineitem rows past the shipdate
# cutoff (small planted capacities), WIDE many (an overflow of the
# capacities planned for SELECTIVE)
SELECTIVE = {"cutoff": days("1998-06-01"), "segment": "BUILDING", "topn": 10}
WIDE = {"cutoff": days("1995-03-15"), "segment": "BUILDING", "topn": 10}


def _settings(s, replan_after=2, shrink_after=3, **kw):
    return dataclasses.replace(s.preset("opt"),
                               compact_replan_after=replan_after,
                               compact_shrink_after=shrink_after, **kw)


def _steps(s, settings, requests, many=False):
    """Run `requests` (bindings, or lists of bindings when `many`) through
    one cache; after each, record the serving entry's capacities and
    counts and the cache's statistics."""
    cache = s.cache(s.db)
    res, trace = [], []
    for req in requests:
        if many:
            res += cache.execute_many(s.plan("q3"), settings, req)
            probe = req[0]
        else:
            res.append(cache.execute(s.plan("q3"), settings, req))
            probe = req
        stats = stats_of(cache)
        cq, _ = cache.get(s.plan("q3"), settings, probe)
        trace.append({"caps": dict(cq.point_caps),
                      "observed": dict(cq.observed_max),
                      "overflows": cq.n_overflows,
                      "stats": stats})
    return res, {"trace": trace}


@pytest.mark.parametrize("qname", ["q3", "q12"])
def test_param_plans_compact_like_the_reference(sides, qname):
    """The first-seen bindings plant the reference's capacities, and the
    default binding runs without overflow."""
    def seq(s):
        cache = s.cache(s.db)
        cq, _ = cache.get(s.plan(qname), s.preset("opt"), s.defaults(qname))
        res = cache.execute(s.plan(qname), s.preset("opt"),
                            s.defaults(qname))
        return [res], {"caps": dict(cq.point_caps),
                       "observed": dict(cq.observed_max),
                       "overflows": cq.n_overflows}

    obs = run_both(sides, seq)
    assert obs["caps"] and obs["overflows"] == 0


def test_overflow_feedback_replans_like_the_reference(sides):
    """Capacities planned for a selective binding -> overflows under a
    wide one -> re-plan from the observed counts -> no more overflows."""
    obs = run_both(sides, lambda s: _steps(
        s, _settings(s, replan_after=2), [SELECTIVE, WIDE, WIDE, WIDE, WIDE]))
    first, replanned, last = obs["trace"][0], obs["trace"][2], \
        obs["trace"][-1]
    assert replanned["stats"]["replans"] == 1
    assert last["overflows"] == 0 and last["caps"] != first["caps"]
    for pid, cap in last["caps"].items():
        if pid in replanned["observed"]:
            assert cap >= observed_bucket(replanned["observed"][pid])
    assert obs["stagings"] <= 4


def test_underuse_feedback_shrinks_like_the_reference(sides):
    obs = run_both(sides, lambda s: _steps(
        s, _settings(s, shrink_after=3), [WIDE] + [SELECTIVE] * 4))
    first, last = obs["trace"][0], obs["trace"][-1]
    assert last["stats"]["shrinks"] == 1 and last["stats"]["replans"] == 0
    assert sum(last["caps"].values()) < sum(first["caps"].values())


def test_feedback_loop_batched_like_the_reference(sides):
    def seq(s):
        wides = [dict(WIDE), dict(WIDE, cutoff=days("1995-04-15"))]
        return _steps(s, _settings(s, replan_after=2),
                      [[SELECTIVE], wides, wides], many=True)

    obs = run_both(sides, seq)
    assert obs["trace"][1]["stats"]["replans"] == 1
    assert obs["trace"][-1]["overflows"] == 0


def test_shrink_decay_survives_a_later_replan(sides):
    tiny = dict(WIDE, cutoff=days("1998-11-01"))    # deep underuse
    medium = dict(WIDE, cutoff=days("1998-06-01"))  # a modest overflow
    obs = run_both(sides, lambda s: _steps(
        s, _settings(s, replan_after=1, shrink_after=2),
        [WIDE, tiny, tiny, tiny, medium, medium]))
    wide_caps, last = obs["trace"][0]["caps"], obs["trace"][-1]
    assert last["stats"]["shrinks"] >= 1 and last["stats"]["replans"] == 1
    assert last["overflows"] == 0
    shared = set(last["caps"]) & set(wide_caps)
    assert shared and all(last["caps"][p] < wide_caps[p] for p in shared)


def test_feedback_off_never_replans(sides):
    obs = run_both(sides, lambda s: _steps(
        s, _settings(s, replan_after=1, compact_feedback=False),
        [SELECTIVE, WIDE, WIDE, WIDE]))
    last = obs["trace"][-1]
    assert last["overflows"] == 3
    assert last["stats"]["replans"] == last["stats"]["shrinks"] == 0


# ---------------------------------------------------------------------------
# hand-planted points and the overflow twin
# ---------------------------------------------------------------------------

def _hand_planted(s, qty: float):
    """count and sum over `l_quantity < qty`, squeezed through 64 rows."""
    if s.name == "port":
        from repro_torch.core.expr import Cmp, col, lit
        from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select
    else:
        from repro.core.expr import Cmp, col, lit
        from repro.core.ir import Agg, AggSpec, Compact, Scan, Select
    sel = Select(Scan("lineitem"), Cmp("<", col("l_quantity"), lit(qty)))
    return Agg(Compact(sel, 64), [],
               [AggSpec("s", "sum", col("l_extendedprice")),
                AggSpec("c", "count")])


def test_overflow_falls_back_to_the_twin_like_the_reference(sides):
    """Every run overflows the 64-row point; the twin is staged once and
    its probe's true count is folded into `observed_max`."""
    def seq(s):
        cq = s.query(_hand_planted(s, 26.0), s.db, s.preset("opt"))
        r1, r2 = cq.run(), cq.run()
        return [r1, r2], {"overflows": cq.n_overflows,
                          "observed": dict(cq.observed_max),
                          "points": cq.compaction_points}

    obs = run_both(sides, seq)
    assert obs["overflows"] == 2 and obs["stagings"] == 2
    assert obs["observed"]["h0"] > 64


def test_observed_counts_are_true_counts(sides):
    def seq(s):
        cq = s.query(_hand_planted(s, 26.0), s.db, s.preset("naive"))
        res = cq.run()
        return [res], {"observed": dict(cq.observed_max),
                       "count": int(res["c"][0])}

    obs = run_both(sides, seq)
    assert obs["observed"] == {"h0": obs["count"]} and obs["count"] > 64


def test_hand_planted_point_replans_from_observed(sides):
    def seq(s):
        settings = _settings(s, replan_after=1)
        cache = s.cache(s.db)
        res = [cache.execute(_hand_planted(s, 2.0), settings)]
        replans = cache.stats.replans
        cq, _ = cache.get(_hand_planted(s, 2.0), settings)
        res.append(cache.execute(_hand_planted(s, 2.0), settings))
        return res, {"replans": replans, "caps": dict(cq.point_caps),
                     "overflows": cq.n_overflows,
                     "stats": stats_of(cache)}

    obs = run_both(sides, seq)
    assert obs["replans"] == 1 and obs["overflows"] == 0
    assert obs["caps"]["h0"] > 64


def test_a_planted_overflow_reaches_the_cache_alike_from_walk_and_pass(
        pdb, monkeypatch):
    """q6's Select squeezed through 64 rows, which its default binding
    overflows and a one-unit quantity cutoff leaves empty: three scalar
    walks (`execute`) hand the cache's feedback step the same snapshot
    and, summed, the same overflow count as one batched pass of the same
    bindings (`run_many`).  The Volcano tier's record counts its runs and
    records nothing."""
    from repro_torch.core import PlanCache, preset
    from repro_torch.core.ir import Agg, Compact
    from repro_torch.core.observations import Harvest
    from repro_torch.core.volcano import OracleQuery
    from repro_torch.relational.queries import PARAM_QUERIES

    build, defaults = PARAM_QUERIES["q6"]
    q6 = build()
    plan = Agg(Compact(q6.child, 64), [], q6.aggs)
    bindings = [dict(defaults, qty_max=1.0), defaults,
                dict(defaults, qty_max=1.0)]
    settings = preset("opt")

    def harvests(walks: bool):
        cache = PlanCache(pdb, device="cpu")
        got, step = [], cache._feedback_step
        monkeypatch.setattr(cache, "_feedback_step",
                            lambda cq, h: got.append(h) or step(cq, h))
        if walks:
            for b in bindings:
                cache.execute(plan, settings, b)
        else:
            cq, _ = cache.get(plan, settings, defaults)
            cache.run_many(cq, bindings)
            assert cq.n_executions == 1
        assert cache.stats.overflows == 1
        assert cache.stats.compactions == 3
        return got

    walked, passed = harvests(True), harvests(False)
    assert [h.overflows for h in walked] == [0, 1, 0]
    assert passed == [dataclasses.replace(walked[-1], overflows=1)]
    assert passed[0].observed["h0"] > 64 and passed[0].under_streak == 1

    oq = OracleQuery(plan, pdb, params=defaults)
    oq.run_many(bindings)
    assert oq.observations.n_executions == 3
    assert oq.observations.harvest() == Harvest(0, {}, {}, 0, {})
    assert not any(hasattr(oq, f) for f in (
        "_obs_lock", "observed_max", "observed_shard", "under_streak",
        "streak_max"))
