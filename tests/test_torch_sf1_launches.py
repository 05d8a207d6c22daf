"""The plans at TPC-H SF 1, where `chip_smoke.py` runs them on the card.

Compaction points and kernel routes are chosen at plan time from table
statistics, so a plan at SF 1 can differ from the same query's plan at
sf 0.01 (q7 compacts twice at sf 0.01 and once at SF 1).  Here, on the
CPU, without running a query at SF 1:

  * the port's optimized plan is the reference's, for all 15 queries at
    every compiled rung;
  * the reference's kernel entry calls at `opt-pallas`, counted while
    its staged program is traced (`jax.make_jaxpr`: abstract values, no
    execution), are `chip_smoke.LAUNCHES_SF1`, the launches the card run
    requires of the port, for the column layout of every query and the
    row layout of `chip_smoke.ROW_QUERIES`;
  * the same for the parameterized plans through the reference's
    `PlanCache`, under the default and the alternative bindings: they
    are `chip_smoke.LAUNCHES_SF1_PARAM`, which the card's serving phase
    requires.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import pytest

import repro.kernels.ops as ref_kops
from repro.core import CompiledQuery as RefCompiledQuery
from repro.core import PlanCache as RefPlanCache
from repro.core import ir as RIR
from repro.core import preset as ref_preset
from repro.core.passes.pipeline import optimize as ref_optimize
from repro.relational import Database as RefDatabase
from repro.relational.queries import PARAM_ALT_BINDINGS as REF_PARAM_ALT
from repro.relational.queries import PARAM_QUERIES as REF_PARAM_QUERIES
from repro.relational.queries import QUERIES as REF_QUERIES
from repro_torch.core import ir as PIR
from repro_torch.core import preset
from repro_torch.core.passes.pipeline import optimize
from repro_torch.relational import Database
from repro_torch.relational.queries import QUERIES

RUNGS = ["naive", "template", "tpch", "strdict", "opt", "opt-pallas"]
# the reference's entry points, by the port's kernel launch counters
ENTRY = {"compact_query": "compact", "compact_pred_query": "compact_pred",
         "filter_agg_query": "filter_agg",
         "selective_agg_query": "selective_filter_agg"}


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(scope="module")
def ref_db():
    return RefDatabase.tpch(sf=1.0, seed=0)


@pytest.fixture(scope="module")
def port_db():
    return Database.tpch(sf=1.0, seed=0)


@pytest.mark.parametrize("pname", RUNGS)
@pytest.mark.parametrize("qname", sorted(REF_QUERIES))
def test_port_plans_the_reference_plan_at_sf1(ref_db, port_db, qname, pname):
    want = ref_optimize(REF_QUERIES[qname](), ref_db, ref_preset(pname))
    got = optimize(QUERIES[qname](), port_db, preset(pname))
    assert PIR.plan_repr(got) == RIR.plan_repr(want)


def _traced_calls(cq, runtime=None) -> dict:
    """The reference's kernel entry calls while `cq`'s staged program is
    traced under `runtime`'s bindings."""
    calls: dict = {}
    saved = {e: getattr(ref_kops, e) for e in ENTRY}

    def wrap(entry, fn):
        def g(*a, **k):
            calls[ENTRY[entry]] = calls.get(ENTRY[entry], 0) + 1
            return fn(*a, **k)
        return g

    for e, fn in saved.items():
        setattr(ref_kops, e, wrap(e, fn))
    try:
        jax.make_jaxpr(cq.fn)(cq.bind(runtime))
    finally:
        for e, fn in saved.items():
            setattr(ref_kops, e, fn)
    return calls


@pytest.mark.parametrize("layout,qname",
                         [("column", q) for q in sorted(REF_QUERIES)]
                         + [("row", q) for q in CS.ROW_QUERIES])
def test_reference_calls_at_sf1_are_the_card_launch_table(ref_db, layout,
                                                          qname):
    settings = dataclasses.replace(ref_preset("opt-pallas"), layout=layout)
    cq = RefCompiledQuery(REF_QUERIES[qname](), ref_db, settings)
    assert _traced_calls(cq) == CS.LAUNCHES_SF1[qname]


def test_launch_table_covers_every_query():
    assert sorted(CS.LAUNCHES_SF1) == sorted(QUERIES)


@pytest.mark.parametrize("binding", ["default", "alt"])
@pytest.mark.parametrize("qname", sorted(REF_PARAM_QUERIES))
def test_reference_param_calls_at_sf1_are_the_card_launch_table(
        ref_db, qname, binding):
    """The serving path's plans: a cache whose first request for the
    shape carries the default bindings (so its capacities are planned
    for them, as `chip_smoke.py` phase 7 sends them), then one execution
    under each binding."""
    build, defaults = REF_PARAM_QUERIES[qname]
    cache = RefPlanCache(ref_db)
    cache.get(build(), ref_preset("opt-pallas"), defaults)
    bindings = defaults if binding == "default" \
        else dict(defaults, **REF_PARAM_ALT[qname])
    cq, runtime = cache.get(build(), ref_preset("opt-pallas"), bindings)
    assert _traced_calls(cq, runtime) == CS.LAUNCHES_SF1_PARAM[qname]


def test_param_launch_table_covers_every_param_query():
    assert sorted(CS.LAUNCHES_SF1_PARAM) == sorted(REF_PARAM_QUERIES)
