"""The port's own plan fuzzer (`repro_torch.core.analysis.fuzz`) against
the reference's (`repro.core.analysis.fuzz`), on the CPU at sf 0.01,
seed 0:

  * `random_plan` draws the reference's plans: the same `repr` for the
    same seed;
  * `results_match` gives the reference's verdict on crafted pairs;
  * `run_fuzz` over 8 seeds at every rung (`optimize()` with the verifier
    on at the ladder, `opt-pallas` and `opt-shard` over 4 virtual CPU
    slots; `naive`, `opt` and `opt-pallas` compiled against the port's
    Volcano) reports no failure;
  * the CLI writes its report.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import ir as RIR
from repro.core.analysis import fuzz as ref_fuzz
from repro_torch.core import ir as PIR
from repro_torch.core import mesh
from repro_torch.core.analysis import fuzz
from repro_torch.relational import Database


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


@pytest.mark.parametrize("seed", range(50))
def test_random_plan_is_the_reference_plan(db, pdb, seed):
    want = ref_fuzz.random_plan(np.random.default_rng(seed), db)
    got = fuzz.random_plan(np.random.default_rng(seed), pdb)
    assert PIR.plan_repr(got) == RIR.plan_repr(want)


def _res(**cols):
    return {k: np.asarray(v) for k, v in cols.items()}


PAIRS = {
    "equal": (_res(a=[1, 2], x=[0.5, 1.5]), _res(a=[1, 2], x=[0.5, 1.5])),
    "row_order": (_res(a=[2, 1], x=[1.5, 0.5]), _res(a=[1, 2], x=[0.5, 1.5])),
    "float_within_tolerance": (_res(x=[1000.0, 1.0]),
                               _res(x=[1001.0, 1.005])),
    "float_drift": (_res(x=[1000.0]), _res(x=[1010.0])),
    "nan_equal": (_res(x=[np.nan, 1.0]), _res(x=[np.nan, 1.0])),
    "int_differs": (_res(a=[1, 2]), _res(a=[1, 3])),
    "columns_differ": (_res(a=[1]), _res(b=[1])),
    "row_counts_differ": (_res(a=[1, 2]), _res(a=[1])),
    "empty": ({}, {}),
    "strings": (_res(s=["b", "a"]), _res(s=["a", "b"])),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_results_match_gives_the_reference_verdict(pair):
    a, b = PAIRS[pair]
    assert fuzz.results_match(a, b) == ref_fuzz.results_match(a, b)


def test_results_match_verdicts_are_the_expected_ones():
    verdicts = {k: fuzz.results_match(*v) is None for k, v in PAIRS.items()}
    assert verdicts == {
        "equal": True, "row_order": True, "float_within_tolerance": True,
        "float_drift": False, "nan_equal": True, "int_differs": False,
        "columns_differ": False, "row_counts_differ": False, "empty": True,
        "strings": True}


def test_run_fuzz_every_rung_on_the_cpu(pdb):
    mesh.virtual_devices("cpu", 4)
    try:
        rep = fuzz.run_fuzz(pdb, 8, device="cpu")
    finally:
        mesh.virtual_devices("cpu", 1)
    assert rep.failures == []
    assert rep.n_plans == 8
    # 7 optimize rungs (dbx, naive, tpch, strdict, opt, opt-pallas,
    # opt-shard) and 3 compiled ones a plan
    assert rep.n_optimized == 8 * 7
    assert rep.n_compiled == 8 * 3


def test_run_fuzz_opt_shard_plans_over_the_slots(pdb):
    """The opt-shard rung runs the Sharding pass on the virtual slots:
    the plans it verifies are partitioned 4 ways."""
    from repro_torch.core import optimize, preset

    mesh.virtual_devices("cpu", 4)
    try:
        rep = fuzz.run_fuzz(pdb, 4, presets=["opt-shard"], device="cpu",
                            compile_every=0)
        lowered = [optimize(fuzz.random_plan(np.random.default_rng(i), pdb),
                            pdb, preset("opt-shard"), device="cpu")
                   for i in range(4)]
    finally:
        mesh.virtual_devices("cpu", 1)
    assert rep.failures == [] and rep.n_optimized == 4
    shards = [s.shard.n_shards for p in lowered for s in PIR.walk(p)
              if isinstance(s, PIR.Scan) and s.shard is not None]
    assert shards and set(shards) == {4}


def test_cli_writes_its_report(tmp_path):
    out = tmp_path / "fuzz.json"
    rc = fuzz.main(["--n", "3", "--sf", "0.01", "--device", "cpu",
                    "--out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert got["n_plans"] == 3 and got["n_failures"] == 0
    assert got["n_optimized"] == 3 * 7 and got["device"] == "cpu"
    # the CLI gives the CPU its one real device back
    assert len(mesh.visible_devices("cpu")) == 1
