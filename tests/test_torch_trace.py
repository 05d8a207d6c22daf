"""The port's host spans (`repro_torch.core.spans`), on the CPU at sf 0.01,
seed 0: with no profiler recording, `span()` is one shared null context
and no `record_function` is made; under `torch.profiler.profile`, `run()`
records the staged walk (`repro.walk`) with its operators
(`repro.op.<Node>`) nested inside, then the count read, the result copy
and the decode, a vmapped bind-many pass and a sharded walk still run,
and an overflow records its re-run.  The answers are the same with the
profiler as without it."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, mesh, preset, spans
from repro_torch.core import compile as compile_mod
from repro_torch.core.expr import Cmp, col, lit
from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.relational import Database
from repro_torch.relational.queries import PARAM_QUERIES, QUERIES

PLANS = ["q1", "q3", "q6", "q9full", "q12"]
AFTER_WALK = ("repro.counts", "repro.result.copy", "repro.result.decode")


@pytest.fixture(scope="module")
def pdb():
    return Database.tpch(sf=0.01, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _profiled(fn):
    """(fn's result, the `repro.` host events it recorded)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("repro.")]


def _inside(inner, outer) -> bool:
    return inner.thread == outer.thread \
        and outer.time_range.start <= inner.time_range.start \
        and inner.time_range.end <= outer.time_range.end


def _same(got: dict, want: dict):
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_without_a_profiler_span_is_the_shared_null_context(pdb,
                                                            monkeypatch):
    off = spans.span("repro.walk")
    assert isinstance(off, contextlib.nullcontext)
    assert spans.span("repro.op.Scan") is off

    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    cq = CompiledQuery(QUERIES["q3"](), pdb, preset("opt-pallas"),
                       device="cpu")
    assert len(cq.run()["revenue"]) > 0


@pytest.mark.parametrize("qname", PLANS)
def test_run_records_the_walk_its_operators_and_the_result(pdb, qname):
    cq = CompiledQuery(QUERIES[qname](), pdb, preset("opt-pallas"),
                       device="cpu")
    want = cq.run()
    got, events = _profiled(cq.run)
    _same(got, want)
    walks = [e for e in events if e.name == "repro.walk"]
    assert len(walks) == 1
    walk = walks[0]
    ops = [e for e in events if e.name.startswith("repro.op.")]
    assert {e.name for e in ops} >= {"repro.op.Scan", "repro.op.Agg"}
    assert all(_inside(e, walk) for e in ops)
    # the plan's root is the outermost operator, and every other nests in it
    roots = [e for e in ops if not any(o is not e and _inside(e, o)
                                       for o in ops)]
    assert [e.name for e in roots] == [f"repro.op.{type(cq.plan).__name__}"]
    after = [e for e in events if e.name in AFTER_WALK]
    counted = cq.compaction_points + cq.measure_points > 0
    assert [e.name for e in after] == list(AFTER_WALK)[not counted:]
    assert walk.time_range.end <= after[0].time_range.start
    for a, b in zip(after, after[1:]):
        assert a.time_range.end <= b.time_range.start
    assert not any(e.name == "repro.rerun" for e in events)


@pytest.mark.parametrize("qname", ["q6", "q12"])
def test_a_vmapped_pass_runs_under_the_profiler(pdb, qname):
    build, defaults = PARAM_QUERIES[qname]
    plan = build()
    spec = plan_params(plan)
    runtime = {k: defaults[k] for k, i in spec.items() if not i.structural}
    plan = bind_plan(plan, {k: defaults[k] for k, i in spec.items()
                            if i.structural})
    cq = CompiledQuery(plan, pdb, preset("opt-pallas"), params=runtime,
                       device="cpu")
    n = compile_mod.BATCH_MIN + 1
    key = next(k for k, v in runtime.items() if isinstance(v, int))
    bindings = [dict(runtime, **{key: runtime[key] + 30 * i})
                for i in range(n)]
    want = cq.run_many(bindings)
    got, events = _profiled(lambda: cq.run_many(bindings))
    for g, w in zip(got, want):
        _same(g, w)
    names = [e.name for e in events]
    assert names.count("repro.walk") == 1
    assert names.count("repro.result.decode") == n
    assert any(name.startswith("repro.op.") for name in names)


def test_a_sharded_walk_runs_under_the_profiler(pdb):
    """The walk runs in each shard's thread of the mesh."""
    mesh.virtual_devices("cpu", 2)
    try:
        cq = CompiledQuery(QUERIES["q3"](), pdb,
                           dataclasses.replace(preset("opt"), shards=2),
                           device="cpu")
        want = cq.run()
        got, events = _profiled(cq.run)
    finally:
        mesh.virtual_devices("cpu", 1)
    _same(got, want)
    assert {"repro.counts", "repro.result.decode"} <= {e.name for e in events}


def test_an_overflow_records_its_rerun(pdb):
    """A point of 64 rows under about half of lineitem's rows overflows
    on every run: the twin's walk re-runs inside `repro.rerun`."""
    sel = Select(Scan("lineitem"), Cmp("<", col("l_quantity"), lit(26.0)))
    plan = Agg(Compact(sel, 64), [], [AggSpec("s", "sum",
                                              col("l_extendedprice")),
                                      AggSpec("c", "count")])
    cq = CompiledQuery(plan, pdb, preset("opt"), device="cpu")
    want = cq.run()
    got, events = _profiled(cq.run)
    _same(got, want)
    assert cq.n_overflows == 2
    reruns = [e for e in events if e.name == "repro.rerun"]
    walks = [e for e in events if e.name == "repro.walk"]
    assert len(reruns) == 1 and len(walks) == 2
    assert _inside(walks[1], reruns[0]) and not _inside(walks[0], reruns[0])
