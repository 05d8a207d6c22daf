"""The port under the reference's plan fuzzer: seeded random TPC-H plans
from `repro.core.analysis.fuzz.random_plan`, converted into the port's
IR, run through `repro_torch.core.CompiledQuery(device="cpu")` at
`naive`, `opt` and `opt-pallas`, and held against the reference's
Volcano engine with `fuzz.results_match` (sort-insensitive, rtol 2e-3 /
atol 1e-2 on floats, exact otherwise).  The plans cover FK join chains,
the composite lineitem->partsupp join, semi and anti joins, CAT group
keys and Sort + Limit over an aggregation.

Also the plan the fuzzer found the top-k tie fault with, by name."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import VolcanoEngine
from repro.core import expr as RE
from repro.core import ir as RIR
from repro.core.analysis import fuzz
from repro_torch.core import CompiledQuery
from repro_torch.core import expr as PE
from repro_torch.core import ir as PIR
from repro_torch.core import preset
from repro_torch.relational import Database

SEEDS = list(range(36))    # 34 and 35 reach bucket_gather
PRESETS = ["naive", "opt", "opt-pallas"]
_PORT = {RIR.__name__: PIR, RE.__name__: PE}


def to_port(x):
    """A reference plan or expression as the same tree of the port's IR
    (the two packages' dataclasses share names and fields)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(_PORT[type(x).__module__], type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    return x


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's small queries run on one torch thread: beside other
    pytest-xdist workers, torch's default of a thread per core
    oversubscribes the cores and slows every worker several times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pdb():
    return Database.tpch(sf=0.01, seed=0)


@pytest.fixture(scope="module")
def plans(db):
    """seed -> (reference plan, Volcano's answer), each computed once."""
    eng = VolcanoEngine(db)
    out = {}
    for seed in SEEDS:
        plan = fuzz.random_plan(np.random.default_rng(seed), db)
        out[seed] = (plan, eng.execute(copy.deepcopy(plan)))
    return out


def test_plans_cover_the_ported_strategies(db, pdb, plans):
    """The seeds reach every join strategy and the generic aggregation
    somewhere on the ladder, and a Sort + Limit over an aggregation."""
    from repro_torch.core import optimize

    seen = set()
    for plan, _ in plans.values():
        for pname in PRESETS:
            for n in PIR.walk(optimize(to_port(copy.deepcopy(plan)), pdb,
                                       preset(pname))):
                if isinstance(n, PIR.Join):
                    seen.add(n.strategy)
                elif isinstance(n, PIR.Agg):
                    seen.add(f"agg:{n.strategy}")
                elif isinstance(n, PIR.Limit):
                    seen.add("limit")
    assert {"pk_gather", "exists_flag", "generic", "bucket_gather",
            "agg:generic", "agg:dense", "limit"} <= seen, seen


@pytest.mark.parametrize("pname", PRESETS)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_plan_matches_reference_volcano(pdb, plans, seed, pname):
    plan, want = plans[seed]
    cq = CompiledQuery(to_port(copy.deepcopy(plan)), pdb, preset(pname),
                       device="cpu")
    drift = fuzz.results_match(cq.run(), want)
    assert drift is None, f"seed {seed} at {pname}: {drift}\n" \
        f"{RIR.plan_repr(plan)}"


def tie_plan(ir, X, by_count: bool = False):
    """Nine groups of (o_orderstatus, o_orderpriority) in key order: the
    first sort key ties across the 'O' groups, so which of them the top-k
    keeps is the tie rule's choice.  With `by_count` the second key is
    the count, descending, against the order the aggregation leaves its
    groups in (Volcano sorts no string descending)."""
    agg = ir.Agg(ir.Select(ir.Scan("orders"),
                           X.Cmp(">=", X.col("o_totalprice"),
                                 X.lit(102360.10047004603))),
                 ["o_orderstatus", "o_orderpriority"],
                 [ir.AggSpec("a0", "count")])
    second = ("a0", False) if by_count else ("o_orderpriority", True)
    return ir.Limit(ir.Sort(agg, [("o_orderstatus", True), second]), 9)


def _rows(res):
    return list(zip(res["o_orderstatus"], res["o_orderpriority"],
                    np.asarray(res["a0"]).tolist()))


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
def test_topk_ties_keep_the_lowest_rows(db, pdb, pname):
    """Among rows tied on the first sort key the top-k keeps the lowest
    row ids, as `jax.lax.top_k` does: Volcano's nine rows, ending
    O/1-URGENT, O/2-HIGH, O/3-MEDIUM, O/4-NOT SPECI (a `torch.topk` on
    the first key alone returned O/5-LOW in place of O/2-HIGH)."""
    want = VolcanoEngine(db).execute(tie_plan(RIR, RE))
    got = CompiledQuery(tie_plan(PIR, PE), pdb, preset(pname),
                        device="cpu").run()
    rows = _rows(got)
    assert rows == _rows(want)
    assert ("O", "2-HIGH", 868) in rows
    assert not any(p == "5-LOW" for s, p, _ in rows if s == "O")


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
def test_topk_ties_with_a_descending_second_key(db, pdb, pname):
    """The tie plan ordered by status, then count descending: Volcano
    keeps the 'O' groups of 868, 854, 836 and 832 orders and cuts
    O/3-MEDIUM (802).  A selection on the first key that keeps the
    lowest row ids among its ties (the reference's top-k) keeps
    O/1-URGENT to O/4-NOT SPECI instead, O/3-MEDIUM in and O/5-LOW out:
    the rows that survive depend on every key."""
    want = VolcanoEngine(db).execute(tie_plan(RIR, RE, by_count=True))
    got = CompiledQuery(tie_plan(PIR, PE, by_count=True), pdb,
                        preset(pname), device="cpu").run()
    rows = _rows(got)
    assert rows == _rows(want)
    assert ("O", "5-LOW", 836) in rows
    assert not any(p == "3-MEDIUM" for s, p, _ in rows if s == "O")
