"""The port end to end on the CPU: TPC-H q1, q3, q6 and q12 at `opt` and
`opt-pallas` through `repro_torch.core.CompiledQuery(device="cpu")`,
held against the reference `CompiledQuery` and the Volcano oracle with
`test_queries.assert_same` (exact on ints, rtol 2e-3 on floats); plus the
port's input set, kernel-call counts, data generation and import rules."""
import ast
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_kops
from repro.core import CompiledQuery as RefCompiledQuery
from repro.core import VolcanoEngine
from repro.core import preset as ref_preset
from repro.relational.queries import PARAM_ALT_BINDINGS, PARAM_QUERIES
from repro.relational.queries import QUERIES as REF_QUERIES
from repro_torch.core import CompiledQuery, preset
from repro_torch.kernels import ops
from repro_torch.relational import Database
from repro_torch.relational.queries import PARAM_QUERIES as PORT_PARAM_QUERIES
from repro_torch.relational.queries import QUERIES
from test_queries import SORT_INSENSITIVE, assert_same

ROOT = Path(__file__).resolve().parents[1]
SLICE = ["q1", "q3", "q6", "q12"]
PRESETS = ["opt", "opt-pallas"]
KERNELS = ["compact", "compact_pred", "selective_agg", "filter_agg"]
# kernel entry points each query reaches at opt-pallas (sf 0.01)
EXPECT_CALLS = {
    "q1": {"filter_agg": 1},
    "q3": {"compact": 2},
    "q6": {"selective_agg": 1},
    "q12": {"compact_pred": 1, "filter_agg": 1},
}


@pytest.fixture(scope="module")
def pdb():
    return Database.tpch(sf=0.01, seed=0)


@pytest.fixture(scope="module")
def oracle(db):
    eng = VolcanoEngine(db)
    return {q: eng.execute(REF_QUERIES[q]()) for q in SLICE}


@pytest.fixture(scope="module")
def reference(db):
    """Lazily built reference runs: (q, preset) -> (CompiledQuery, result,
    kernel-call counts)."""
    cache = {}

    def get(q, pname):
        if (q, pname) not in cache:
            calls = dict.fromkeys(KERNELS, 0)
            saved = {k: getattr(ref_kops, f"{k}_query") for k in KERNELS}

            def wrap(name, fn):
                def g(*a, **k):
                    calls[name] += 1
                    return fn(*a, **k)
                return g

            for k, fn in saved.items():
                setattr(ref_kops, f"{k}_query", wrap(k, fn))
            try:
                cq = RefCompiledQuery(REF_QUERIES[q](), db, ref_preset(pname))
                res = cq.run()
            finally:
                for k, fn in saved.items():
                    setattr(ref_kops, f"{k}_query", fn)
            cache[q, pname] = (cq, res, calls)
        return cache[q, pname]
    return get


def _port_run(q, db, pname):
    before = dict(ops.calls)
    cq = CompiledQuery(QUERIES[q](), db, preset(pname), device="cpu")
    res = cq.run()
    calls = {k: ops.calls[k] - before[k] for k in KERNELS}
    return cq, res, calls


@pytest.mark.parametrize("pname", PRESETS)
@pytest.mark.parametrize("qname", SLICE)
def test_port_matches_reference_and_oracle(pdb, oracle, reference, qname,
                                           pname):
    cq, got, _ = _port_run(qname, pdb, pname)
    _, want, _ = reference(qname, pname)
    insensitive = qname in SORT_INSENSITIVE
    assert_same(got, want, insensitive)
    assert_same(got, oracle[qname], insensitive)
    assert cq.n_overflows == 0


@pytest.mark.parametrize("pname", PRESETS)
@pytest.mark.parametrize("qname", SLICE)
def test_input_keys_match_reference(pdb, reference, qname, pname):
    """Per-query specialized loading registers the same input set."""
    cq, _, _ = _port_run(qname, pdb, pname)
    ref_cq, _, _ = reference(qname, pname)
    assert set(cq.inputs) == set(ref_cq.inputs)
    for k, v in ref_cq.inputs.items():
        assert cq.inputs[k].shape == np.asarray(v).shape, k


@pytest.mark.parametrize("qname", SLICE)
def test_kernel_calls_match_reference(pdb, reference, qname):
    _, _, got = _port_run(qname, pdb, "opt-pallas")
    _, _, want = reference(qname, "opt-pallas")
    assert got == want
    assert got == {**dict.fromkeys(KERNELS, 0), **EXPECT_CALLS[qname]}
    _, _, plain = _port_run(qname, pdb, "opt")
    assert not any(plain.values())


@pytest.mark.parametrize("pname", PRESETS)
def test_rebinding_params_matches_oracle(db, pdb, pname):
    """q6 with runtime parameters: one staged program, two bindings (the
    kernels take the parameters as scalars)."""
    build, defaults = PORT_PARAM_QUERIES["q6"]
    ref_build, _ = PARAM_QUERIES["q6"]
    cq = CompiledQuery(build(), pdb, preset(pname), params=defaults,
                       device="cpu")
    eng = VolcanoEngine(db)
    for b in (defaults, {**defaults, **PARAM_ALT_BINDINGS["q6"]}):
        assert_same(cq.run(b), eng.execute(ref_build(), params=b), False)


# the other queries whose opt plans need only pk_gather joins and scalar
# and dense aggs (the rest of the ladder: tests/test_torch_ladder.py)
BEYOND = ["q5", "q9", "q10", "q13", "q14", "q17", "q18", "q19"]


@pytest.fixture(scope="module")
def beyond_oracle(db):
    eng = VolcanoEngine(db)
    return {q: eng.execute(REF_QUERIES[q]()) for q in BEYOND}


@pytest.mark.parametrize("pname", PRESETS)
@pytest.mark.parametrize("qname", BEYOND)
def test_queries_beyond_the_slice_match_oracle(pdb, beyond_oracle, qname,
                                               pname):
    cq = CompiledQuery(QUERIES[qname](), pdb, preset(pname), device="cpu")
    assert_same(cq.run(), beyond_oracle[qname], qname in SORT_INSENSITIVE)
    assert cq.n_overflows == 0


def test_tpch_generation_is_byte_identical(db, pdb):
    assert sorted(db.tables) == sorted(pdb.tables)
    for name, t in db.tables.items():
        p = pdb.tables[name]
        assert p.nrows == t.nrows
        assert sorted(p.data) == sorted(t.data)
        for c, arr in t.data.items():
            assert p.data[c].dtype == arr.dtype, (name, c)
            assert p.data[c].tobytes() == arr.tobytes(), (name, c)
        for attr in ("vocabs", "word_vocabs"):
            want, got = getattr(t, attr), getattr(p, attr)
            assert sorted(got) == sorted(want)
            for c in want:
                np.testing.assert_array_equal(got[c], want[c])


def test_subnormal_literal_keeps_its_rows(db, pdb):
    """The falsifying example hypothesis stored for the reference's
    `test_system.py::test_random_query_equivalence`: `l_discount <
    1.1754944e-39` (frac 1.175494351e-38 of the column's range), ungrouped,
    no date bound.  The threshold is a float32 subnormal; the reference's
    XLA on the CPU flushes it to zero and answers s = c = 0, while the
    port keeps it and matches the Volcano oracle (ROADMAP Queue 3)."""
    from repro.core import expr as RE
    from repro.core import ir as rir
    from repro_torch.core import expr as E
    from repro_torch.core import ir as pir

    t = pdb.table("lineitem")
    lo, hi = t.stats["l_discount"].min, t.stats["l_discount"].max
    thresh = float(lo + 1.175494351e-38 * (hi - lo))
    assert 0 < np.float32(thresh) < np.finfo(np.float32).tiny

    def plan(ir, X):
        return ir.Agg(
            ir.Select(ir.Scan("lineitem"),
                      X.Cmp("<", X.col("l_discount"), X.lit(thresh))), [],
            [ir.AggSpec("s", "sum", X.Arith("*", X.col("l_extendedprice"),
                                            X.col("l_quantity"))),
             ir.AggSpec("c", "count")])

    want = VolcanoEngine(db).execute(plan(rir, RE))
    got = CompiledQuery(plan(pir, E), pdb, preset("opt"), device="cpu").run()
    assert int(want["c"][0]) > 0
    assert_same(got, want, False)


def wide_agg_plan(ir, X):
    """17 sums beside one group key: more value columns than one CUDA
    aggregation launch takes (16), which the engine's kernel gate admits
    (ROADMAP Queue 3)."""
    return ir.Agg(ir.Scan("lineitem"), ["l_returnflag"],
                  [ir.AggSpec(f"s{k}", "sum", X.col("l_quantity"))
                   for k in range(17)])


def test_wide_aggregation_matches_reference_and_oracle(db, pdb,
                                                       monkeypatch):
    """The plan reaches the port's aggregation entry point with G = 3,
    A = 17 at opt-pallas (on the card, two launches of 16 and 1 columns)
    and answers as the reference's CompiledQuery and Volcano do."""
    from repro.core import expr as RE
    from repro.core import ir as rir
    from repro_torch.core import expr as E
    from repro_torch.core import ir as pir

    seen = []
    real = ops.filter_agg_query

    def record(mask, gidx, vals, n_groups):
        seen.append((n_groups, len(vals)))
        return real(mask, gidx, vals, n_groups)

    monkeypatch.setattr(ops, "filter_agg_query", record)
    got = CompiledQuery(wide_agg_plan(pir, E), pdb, preset("opt-pallas"),
                        device="cpu").run()
    assert seen == [(3, 17)]
    ref = RefCompiledQuery(wide_agg_plan(rir, RE), db,
                           ref_preset("opt-pallas")).run()
    assert_same(got, ref, False)
    assert_same(got, VolcanoEngine(db).execute(wide_agg_plan(rir, RE)),
                False)


def test_q1_count_order_is_exact_int32(pdb, oracle):
    """q1's count column comes back as int32 at both presets (the kernel's
    exact count at opt-pallas, no float32 detour) and equals the Volcano
    oracle's."""
    for pname in PRESETS:
        got = CompiledQuery(QUERIES["q1"](), pdb, preset(pname),
                            device="cpu").run()
        assert got["count_order"].dtype == np.int32, pname
        want = np.asarray(oracle["q1"]["count_order"])
        order = np.lexsort((got["l_linestatus"], got["l_returnflag"]))
        worder = np.lexsort((oracle["q1"]["l_linestatus"],
                             oracle["q1"]["l_returnflag"]))
        np.testing.assert_array_equal(got["count_order"][order],
                                      want[worder])


def test_from_arrays_gives_the_same_answers(db, oracle):
    state = {name: {"columns": dict(t.data), "vocabs": dict(t.vocabs),
                    "word_vocabs": dict(t.word_vocabs)}
             for name, t in db.tables.items()}
    fdb = Database.from_arrays(copy.deepcopy(state))
    for q in SLICE:
        got = CompiledQuery(QUERIES[q](), fdb, preset("opt-pallas"),
                            device="cpu").run()
        assert_same(got, oracle[q], q in SORT_INSENSITIVE)


def _imports(path: Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"


def test_default_device_is_cuda_and_never_falls_back(pdb, monkeypatch):
    from repro_torch.core import PlanCache
    from repro_torch.serve.query_server import QueryServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CompiledQuery(QUERIES["q6"](), pdb, preset("opt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanCache(pdb)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryServer(pdb, preset("opt"))


def _chip_smoke(*args, cwd=ROOT, script=ROOT / "chip_smoke.py"):
    # one torch thread: beside other pytest-xdist workers, a thread per
    # core oversubscribes the cores and slows the rehearsal many times
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_chip_smoke_rehearsal_reports_every_kernel():
    """The card script's phases, on the CPU at sf 0.01: every kernel
    entry is reached, and the kernels line carries the contract's keys."""
    r = _chip_smoke("--rehearse", "--sf", "0.01")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{"kernels"')]
    assert len(lines) == 1
    rows = json.loads(lines[0])["kernels"]
    assert [k["name"] for k in rows] == [
        "compact", "compact_pred", "filter_agg", "selective_filter_agg",
        "gather_join", "masked_topk", "selective_filter_agg_capacity",
        "compact_batched", "compact_pred_batched", "filter_agg_batched",
        "selective_filter_agg_batched"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "kernels_per_call"}
    for k in rows:
        assert keys <= set(k)
        assert (ROOT / k["source"]).exists()
        assert (ROOT / k["replaces"].split(":")[0]).exists()
        assert k["max_abs_err"] == 0.0 and k["bound_ms"] > 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    if not torch.cuda.is_available():
        r = _chip_smoke()
        assert r.returncode != 0 and '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    r = _chip_smoke("--rehearse", cwd=tmp_path, script=lone)
    assert r.returncode != 0 and '"ok"' not in r.stdout
