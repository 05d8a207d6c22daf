"""The port's examples and scripts on the CPU, and its `REPRO_MOE_GROUP`
lever against the reference's:

  * `examples/quickstart_torch.py`, `examples/tpch_analytics_torch.py`
    (at `opt` and `opt-pallas`) and `examples/serve_lm_torch.py` with
    `--device cpu` at sf 0.01 / smoke width, their answers against the
    reference's Volcano on the same seeded data (`test_queries.
    assert_same`: exact on ints, rtol 2e-3 / atol 1e-2 on floats);
  * `scripts/run_hillclimb_torch.py` (one variant) and
    `scripts/make_tables_torch.py` on the JSON the port's dry run writes
    on the CPU;
  * the MoE at REPRO_MOE_GROUP = 1, 2 and E (and values the reference
    rounds) against the reference under the same variable, within the
    MoE tests' tolerance (rtol 1e-4, atol 1e-5).
"""
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.moe as RMOE
import repro_torch.configs as PC
import repro_torch.models.moe as PMOE
from repro.core import VolcanoEngine as RefVolcano
from repro.relational import Database as RefDatabase
from repro.relational.queries import QUERIES as REF_QUERIES
from test_queries import SORT_INSENSITIVE, assert_same
from test_torch_lm_layers import J, T, close, jmap, moe_params, rnd, tmap

ROOT = Path(__file__).resolve().parent.parent


def load(rel: str):
    """A script of the repo as a module (examples/ and scripts/ are no
    packages)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread beside the other pytest-xdist workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_answers():
    rdb = RefDatabase.tpch(sf=0.01, seed=0)
    eng = RefVolcano(rdb)
    return {q: eng.execute(b()) for q, b in REF_QUERIES.items()}


def test_quickstart_torch_on_the_cpu(ref_answers, capsys):
    got = load("examples/quickstart_torch.py").main(
        ["--sf", "0.01", "--device", "cpu"])
    assert_same(got, ref_answers["q6"], False)
    out = capsys.readouterr().out
    assert "Staged engine [naive] on cpu" in out
    assert "Staged engine [opt] on cpu" in out and "Q6 [opt] result" in out


@pytest.mark.parametrize("config", ["opt", "opt-pallas"])
def test_tpch_analytics_torch_on_the_cpu(ref_answers, config, capsys):
    got = load("examples/tpch_analytics_torch.py").main(
        ["--sf", "0.01", "--config", config, "--device", "cpu"])
    assert set(got) == set(ref_answers)
    for q, res in got.items():
        assert_same(res, ref_answers[q], q in SORT_INSENSITIVE)
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].split()[:2] == ["query", "rows"]
    assert len(lines) == 2 + len(got)


def test_serve_lm_torch_on_the_cpu(capsys):
    mod = load("examples/serve_lm_torch.py")
    reqs, eng = mod.main(["--requests", "6", "--slots", "2", "--device",
                          "cpu"])
    assert len(reqs) == 6 and all(r.done for r in reqs)
    assert all(len(r.out) >= 8 for r in reqs)
    again, _ = mod.main(["--requests", "6", "--slots", "2", "--device",
                         "cpu"])
    assert [r.out for r in again] == [r.out for r in reqs]
    assert "continuous batching over 2 slots on cpu" in \
        capsys.readouterr().out


def test_hillclimb_and_tables_on_the_cpu_dry_run(tmp_path):
    """The dry run's baseline cell in-process, one hill-climb variant in
    the script's own subprocess, then both tables from their JSON."""
    import repro_torch.launch.dryrun as D

    results = tmp_path / "results"
    D.main(["--arch", "qwen1_5_0_5b", "--shape", "train_4k", "--out",
            str(results / "dryrun_torch")])
    cwd = os.getcwd()
    os.chdir(ROOT)                  # the script runs `-m` with src on path
    try:
        ran = load("scripts/run_hillclimb_torch.py").main(
            ["--only", "B1", "--results", str(results)])
    finally:
        os.chdir(cwd)
    assert ran == ["B1_onehot_loss"]
    cell = results / "hillclimb_torch" / "B1_onehot_loss" / \
        "qwen1_5_0_5b__train_4k__pod.json"
    assert json.loads(cell.read_text())["arch"] == "qwen1_5_0_5b"
    roof, hill = load("scripts/make_tables_torch.py").main(
        ["--results", str(results)])
    roof, hill = Path(roof).read_text(), Path(hill).read_text()
    assert "| qwen1_5_0_5b | train_4k | 16x16 |" in roof
    rows = [ln for ln in hill.splitlines() if ln.startswith("| ")][1:]
    assert [r.split("|")[1].strip() for r in rows] == ["baseline",
                                                       "B1_onehot_loss"]


# ---------------------------------------------------------------------------
# REPRO_MOE_GROUP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("group", ["1", "2", "4"])
def test_moe_group_matches_the_reference(monkeypatch, group, shared):
    """G experts a step (G = 1, 2 and E = 4), over capacities that drop
    tokens: the same sums as the reference under the same variable."""
    monkeypatch.setenv("REPRO_MOE_GROUP", group)
    rng = np.random.default_rng(int(group) + 10 * shared)
    e, topk, cap = 4, 2, 8
    p = moe_params(rng, 16, 12, e, shared)
    x = rnd(rng, 24, 16)
    got = PMOE._moe_local(T(x), tmap(p), topk=topk, capacity=cap)
    want = RMOE._moe_local(J(x), jmap(p), topk=topk, capacity=cap,
                           tp_axis=None)
    close(got, want)


@pytest.mark.parametrize("value,group", [("0", 1), ("3", 2), ("99", 4),
                                         ("4", 4)])
def test_moe_group_is_clamped_to_a_divisor(monkeypatch, value, group):
    monkeypatch.setenv("REPRO_MOE_GROUP", value)
    assert PMOE.moe_group(4) == group


def test_moe_group_over_the_model_ffn(monkeypatch):
    """Granite-MoE's smoke config at G = E through `moe_ffn`, against the
    reference at the same G."""
    from repro.models.sharding import Ctx as RCtx
    from repro_torch.models.sharding import Ctx

    cfg = PC.smoke_config("granite_moe_1b_a400m")
    rcfg = RC.smoke_config("granite_moe_1b_a400m")
    monkeypatch.setenv("REPRO_MOE_GROUP", str(cfg.n_experts))
    rng = np.random.default_rng(11)
    p = moe_params(rng, cfg.d_model, cfg.moe_d_ff, cfg.n_experts, False)
    x = rnd(rng, 2, 9, cfg.d_model)
    close(PMOE.moe_ffn(T(x), tmap(p), cfg, Ctx()),
          RMOE.moe_ffn(J(x), jmap(p), rcfg, RCtx(mesh=None)))
