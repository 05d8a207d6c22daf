"""Bind-many in the port, on the CPU at sf 0.01, seed 0:
`CompiledQuery.run_many` (one staged walk under `torch.func.vmap` for N
bindings, its point counts read in one copy, from `BATCH_MIN` bindings
on, in passes of at most `BATCH_MAX`), `PlanCache.execute_many`
(plan-key partitioning) and the query server's coalescing window,
against N `run`s of the same query and against the reference's answers
and accounting for the same requests (`test_queries.assert_same`: exact
on ints, rtol 2e-3 / atol 1e-2 on floats: the batched walk sums a (N, n)
tensor where `run` sums an (n,) one, in another order).  As in the
reference, a batched pass is one execution; unlike it, the port pads no
batch (`CompiledQuery.pads_batches` is False).  vmap's per-example
fallback is off in this module, so an operator without a batching rule
fails instead of looping over the bindings."""
import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, CompiledQueryBatch, preset
from repro_torch.core import compile as compile_mod
from repro_torch.core.ir import Agg, Compact, Select
from repro_torch.kernels import ops as kops
from repro_torch.relational.queries import PARAM_QUERIES, QUERIES
from repro_torch.relational.schema import days
from test_torch_plan_cache import (assert_matches, one_thread,  # noqa: F401
                                   pdb, run_both, sides, stats_of)


def q6_bindings(n):
    """n distinct q6 bindings (vary the quantity cutoff)."""
    _, defaults = PARAM_QUERIES["q6"]
    return [dict(defaults, qty_max=10.0 + 0.35 * i) for i in range(n)]


@pytest.fixture(scope="module", autouse=True)
def no_vmap_fallback():
    """An op with no batching rule raises instead of looping."""
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)


def assert_identical(got: dict, want: dict):
    """A slot of run_many against `run` of its binding: the same columns
    and rows, ints exact, floats to `assert_same` (the batched walk adds
    in another order)."""
    assert set(got) == set(want)
    for k in got:
        if got[k].dtype.kind == "f" or want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k].astype(np.float64),
                                       want[k].astype(np.float64),
                                       rtol=2e-3, atol=1e-2, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_run_many_equals_run_and_the_reference(sides, qname, pname):
    ref, port = sides
    rcache = ref.cache(ref.db)
    rcq, rt = rcache.get(ref.plan(qname), ref.preset("opt"),
                         ref.defaults(qname))
    want = rcq.run_many([rt, dict(rt, **{k: v for k, v in
                                         ref.alt[qname].items() if k in rt})])
    cache = port.cache(port.db)
    cq, rt = cache.get(port.plan(qname), preset(pname), port.defaults(qname))
    alt = dict(rt, **{k: v for k, v in port.alt[qname].items() if k in rt})
    bindings = [rt, alt, rt]
    before, execs = compile_mod.STAGINGS, cq.n_executions
    calls = dict(kops.calls)
    got = cq.run_many(bindings)
    assert compile_mod.STAGINGS == before, "run_many must not re-stage"
    assert cq.n_executions - execs == 1, "one batched pass"
    # each engine entry point once a call site, whatever N is
    cq.run(rt)
    once = {k: kops.calls[k] - v for k, v in calls.items()}
    assert all(c % 2 == 0 for c in once.values()), once
    for g, b in zip(got, bindings):
        assert_identical(g, cq.run(b))
    assert_matches(got[0], want[0])
    assert_matches(got[1], want[1])


def test_run_many_64_bindings(pdb, sides):
    """64 bindings of q6: one batched pass (the reference's one vmapped
    dispatch), no staging, each equal to its `run` and to the reference's
    Volcano under the same binding."""
    ref, _port = sides
    build, defaults = PARAM_QUERIES["q6"]
    cq = CompiledQuery(build(), pdb, preset("opt-pallas"), params=defaults,
                       device="cpu")
    bindings = q6_bindings(64)
    before, execs = compile_mod.STAGINGS, cq.n_executions
    batched = cq.run_many(bindings)
    assert cq.n_executions - execs == 1
    assert compile_mod.STAGINGS == before
    for b, got in zip(bindings, batched):
        assert_identical(got, cq.run(b))
    for b in bindings[::9]:
        assert_matches(batched[bindings.index(b)],
                       ref.oracle.execute(ref.plan("q6"), b))


@pytest.mark.parametrize("n", [1, 2])
def test_run_many_below_batch_min_runs_scalar_walks(pdb, n):
    """Fewer than `BATCH_MIN` bindings: one scalar walk a binding (they
    cost less than a batched pass there), each equal to its `run`; the
    batched pass of the same bindings (`run_batched`) gives the same
    answers."""
    assert n < compile_mod.BATCH_MIN
    build, defaults = PARAM_QUERIES["q6"]
    cq = CompiledQuery(build(), pdb, preset("opt-pallas"), params=defaults,
                       device="cpu")
    bindings = q6_bindings(n)
    calls, execs = dict(kops.calls), cq.n_executions
    got = cq.run_many(bindings)
    assert cq.n_executions - execs == n
    assert kops.calls["selective_agg"] - calls["selective_agg"] == n
    batched = cq.run_batched(bindings)
    assert cq.n_executions - execs == n + 1
    for b, g, h in zip(bindings, got, batched):
        assert_identical(g, cq.run(b))
        assert_identical(h, g)


@pytest.mark.parametrize("n,passes", [(8, 2), (9, 3)])
def test_run_many_splits_into_passes_of_batch_max(pdb, monkeypatch, n,
                                                  passes):
    """More than `BATCH_MAX` bindings run as passes of at most BATCH_MAX
    (a pass's device memory grows with its bindings), of equal sizes
    within one (9 as 3 x 3, so that no pass falls below BATCH_MIN).
    Results stay in order."""
    monkeypatch.setattr(compile_mod, "BATCH_MAX", 4)
    build, defaults = PARAM_QUERIES["q6"]
    cq = CompiledQuery(build(), pdb, preset("opt"), params=defaults,
                       device="cpu")
    bindings = q6_bindings(n)
    got = cq.run_many(bindings)
    assert cq.n_executions == passes
    for b, g in zip(bindings, got):
        assert_identical(g, cq.run(b))


def test_run_many_reads_every_count_in_one_copy(pdb, monkeypatch):
    """q3's two compaction points over five bindings: one device-to-host
    read of all ten counts (the batched pass's), then the results; `run`
    reads its own two in one more."""
    build, defaults = PARAM_QUERIES["q3"]
    plan = build()
    from repro_torch.core.passes.param_binding import bind_plan
    plan = bind_plan(plan, {"segment": defaults["segment"],
                            "topn": defaults["topn"]})
    rt = {"cutoff": defaults["cutoff"]}
    cq = CompiledQuery(plan, pdb, preset("opt"), params=rt, device="cpu")
    assert cq.compaction_points == 2
    reads = []
    real, real_many = cq._counts_to_host, cq._batch_counts_to_host
    monkeypatch.setattr(cq, "_counts_to_host",
                        lambda runs: reads.append(len(runs)) or real(runs))
    monkeypatch.setattr(
        cq, "_batch_counts_to_host",
        lambda counts, n: reads.append(n) or real_many(counts, n))
    bindings = [{"cutoff": days("1995-03-15") + 30 * i} for i in range(5)]
    got = cq.run_many(bindings)
    assert reads == [5]
    assert cq.run(bindings[2]) is not None and reads == [5, 1]
    assert_identical(got[2], cq.run(bindings[2]))


def test_run_many_without_params_returns_independent_copies(pdb):
    cq = CompiledQuery(QUERIES["q6"](), pdb, preset("opt"), device="cpu")
    before = compile_mod.STAGINGS
    a, b = cq.run_many([None, None])
    assert compile_mod.STAGINGS == before
    assert_identical(a, b)
    a["revenue"][:] = -1
    assert not np.array_equal(a["revenue"], b["revenue"])
    with pytest.raises(KeyError):
        cq.run_many([{"bogus": 1}])


def test_run_many_reruns_only_the_overflowing_slots(pdb, sides):
    """A hand-planted 64-row point: only the binding that overflows it
    re-runs through the twin, and every slot equals its `run`."""
    ref, _port = sides
    build, defaults = PARAM_QUERIES["q6"]
    plan = build()
    assert isinstance(plan.child, Select)
    plan = Agg(Compact(plan.child, 64), [], plan.aggs)
    cq = CompiledQuery(plan, pdb, preset("opt"), params=defaults,
                       device="cpu")
    tiny = dict(defaults, qty_max=1.0)      # l_quantity < 1: no row
    bindings = [tiny, defaults, tiny]
    results = cq.run_many(bindings)
    assert cq.n_overflows == 1
    for got, b in zip(results, bindings):
        assert_identical(got, cq.run(b))
        assert_matches(got, ref.oracle.execute(ref.plan("q6"), b))


def _plant(plan, capacity: int) -> None:
    """Put the first Select of `plan` (in field order) under a hand-
    planted Compact of `capacity` rows."""
    import dataclasses

    from repro_torch.core import ir

    def rec(p):
        for f in dataclasses.fields(p):
            c = getattr(p, f.name)
            if isinstance(c, ir.Select):
                setattr(p, f.name, Compact(c, capacity))
                return True
            if isinstance(c, ir.Plan) and rec(c):
                return True
        return False

    assert rec(plan)


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
@pytest.mark.parametrize("qname", ["q1", "q3", "q6", "q12", "q14"])
def test_run_many_overflow_reruns_one_slot(sides, pdb, qname, pname):
    """A point planted at the first Select, its capacity the smaller of
    the default and the alternative bindings' true counts (measured by a
    measure-only point first): in a pass of (small, large, small) only
    the large slot overflows and re-runs through the twin, and every
    slot equals its `run` and the reference's Volcano.  (q19's plan has
    no Select whose rows depend on its parameters.)"""
    from repro_torch.core.passes.param_binding import bind_plan

    ref, port = sides
    build, d = PARAM_QUERIES[qname]
    full = [port.defaults(qname), port.alt_bindings(qname)]
    runtime = [{k: v for k, v in b.items()
                if not isinstance(v, str) and k != "topn"} for b in full]
    structural = {k: v for k, v in d.items() if k not in runtime[0]}

    def compiled(capacity, settings):
        plan = bind_plan(build(), structural)
        _plant(plan, capacity)
        return CompiledQuery(plan, pdb, settings, params=runtime[0],
                             device="cpu")

    probe = compiled(0, preset("opt"))
    counts = probe.execute_many(probe.bind_many(runtime))[2]["h0"].tolist()
    assert counts[0] != counts[1], counts
    small = int(np.argmin(counts))
    cq = compiled(min(counts), preset(pname))
    order = [small, 1 - small, small]
    results = cq.run_many([runtime[i] for i in order])
    assert cq.n_overflows == 1 and cq.n_executions == 1
    assert cq._fallback is not None and cq._fallback.n_executions == 1
    for got, i in zip(results, order):
        assert_identical(got, cq.run(runtime[i]))
        assert_matches(got, ref.oracle.execute(ref.plan(qname), full[i]))


def test_execute_many_partitions_by_plan_key(sides):
    """Compile-time params split the batch: q3 with two LIMIT values runs
    as two groups against two entries, results back in order."""
    def seq(s):
        cache = s.cache(s.db)
        d = s.defaults("q3")
        reqs = [d, dict(d, topn=5), dict(d, cutoff=days("1995-06-15")),
                dict(d, topn=5, cutoff=days("1995-06-15"))]
        res = cache.execute_many(s.plan("q3"), s.preset("opt"), reqs)
        assert [len(next(iter(r.values()))) for r in res] == [10, 5, 10, 5]
        return res, stats_of(cache)

    obs = run_both(sides, seq)
    assert obs["compiles"] == 2 and (obs["hits"], obs["misses"]) == (2, 2)


def test_execute_many_accounting_like_the_reference(sides):
    def seq(s):
        cache = s.cache(s.db)
        res = cache.execute_many(s.plan("q6"), s.preset("opt"),
                                 q6_bindings(5))
        res += cache.execute_many(s.plan("q6"), s.preset("opt"),
                                  q6_bindings(1))
        return res, stats_of(cache)

    obs = run_both(sides, seq)
    assert (obs["hits"], obs["misses"], obs["compiles"]) == (5, 1, 1)


def test_compiled_query_batch_equals_single_runs(pdb, sides):
    ref, _port = sides
    batch = CompiledQueryBatch([QUERIES[q]() for q in ("q1", "q3", "q6")],
                               pdb, preset("opt-pallas"), device="cpu")
    for q, got, cq in zip(("q1", "q3", "q6"), batch.run(), batch.queries):
        assert_identical(got, cq.run())
        assert_matches(got, ref.oracle.execute(ref.queries[q]()))
    assert batch.input_nbytes() == sum(q.input_nbytes()
                                       for q in batch.queries)


# ---------------------------------------------------------------------------
# the server's coalescing window
# ---------------------------------------------------------------------------

def test_server_coalesces_same_key_requests_into_one_run_many(sides):
    """16 q6 requests inside one window: one group, one `run_many` (one
    batched pass), results scattered back per request."""
    ref, port = sides
    bindings = q6_bindings(16)
    with port.server(port.db, preset("opt-pallas"), window_s=3600.0,
                     max_batch=128) as srv:
        futs = [srv.submit(port.plan("q6"), b) for b in bindings]
        srv.drain()
        results = [f.result(timeout=60) for f in futs]
        assert srv.stats.batches == 1 and srv.stats.coalesced == 16
        assert srv.stats.completed == 16 and srv.stats.errors == 0
        assert srv.cache.stats.compiles == 1
        cq, _ = srv.cache.get(port.plan("q6"), preset("opt-pallas"),
                              bindings[0])
        assert cq.n_executions == 1
    for b, got in zip(bindings, results):
        assert_matches(got, ref.oracle.execute(ref.plan("q6"), b))


def test_server_windows_partition_by_plan_key(sides):
    """q6 and two structural variants of q3 form three windows, in both
    packages."""
    def seq(s):
        d6, d3 = s.defaults("q6"), s.defaults("q3")
        reqs = [(s.plan("q6"), d6), (s.plan("q3"), d3),
                (s.plan("q6"), dict(d6, qty_max=30.0)),
                (s.plan("q3"), dict(d3, topn=5)),
                (s.plan("q6"), dict(d6, qty_max=35.0))]
        with s.server(s.db, s.preset("opt"), window_s=3600.0) as srv:
            futs = [srv.submit(p, b) for p, b in reqs]
            srv.flush()
            res = [f.result(timeout=120) for f in futs]
            st = srv.stats
        return res, {"batches": st.batches, "coalesced": st.coalesced,
                     "compiles": srv.cache.stats.compiles}

    assert run_both(sides, seq) == {"batches": 3, "coalesced": 3,
                                    "compiles": 3, "stagings": 3}


def test_server_drain_flushes_partial_window(sides):
    _ref, port = sides
    with port.server(port.db, preset("opt"), window_s=3600.0,
                     max_batch=64) as srv:
        futs = [srv.submit(port.plan("q6"), b) for b in q6_bindings(3)]
        assert not any(f.done() for f in futs)
        srv.drain()
        assert all(f.done() for f in futs)
        assert srv.stats.completed == 3 and srv.stats.batches == 1


def test_server_cancelled_request_does_not_poison_window_or_drain(sides):
    ref, port = sides
    with port.server(port.db, preset("opt"), window_s=3600.0,
                     max_batch=64) as srv:
        futs = [srv.submit(port.plan("q6"), b) for b in q6_bindings(5)]
        assert futs[2].cancel()
        srv.drain()
        assert all(f.done() for f in futs) and srv.stats.errors == 0
        others = [f.result(timeout=60) for i, f in enumerate(futs) if i != 2]
    assert len(others) == 4
    assert_matches(others[0], ref.oracle.execute(ref.plan("q6"),
                                                 q6_bindings(1)[0]))


def test_server_full_window_dispatches_without_tick(sides):
    _ref, port = sides
    with port.server(port.db, preset("opt"), window_s=3600.0,
                     max_batch=4) as srv:
        futs = [srv.submit(port.plan("q6"), b) for b in q6_bindings(4)]
        assert len([f.result(timeout=120) for f in futs]) == 4
        assert srv.stats.batches == 1 and srv.stats.coalesced == 4
