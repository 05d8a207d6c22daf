"""The port's engine ladder on the CPU: all 15 TPC-H queries at `naive`,
`template`, `tpch`, `strdict`, `opt` and `opt-pallas` through
`repro_torch.core.CompiledQuery(device="cpu")` at sf 0.01, held against
the reference's Volcano engine with `test_queries.assert_same` (exact on
ints, rtol 2e-3 on floats).  Beside it:

  * q4, q7 and q9full (the exists_flag, generic and bucket_gather joins)
    against the reference's `CompiledQuery`: the same answers, input keys
    and kernel-call counts;
  * the port's own Volcano engine (the dbx rung) against the reference's;
  * the row layout (`tests/test_layout.py`'s analogue) at `naive`, `opt`
    and `opt-pallas`, with the integer probe above 2^24 and the wide-int
    round trip, and the generated kernel source over strided columns;
  * the composite-key pack bound, refused at staging in both packages.
"""
import copy
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_kops
from repro.core import CompiledQuery as RefCompiledQuery
from repro.core import VolcanoEngine as RefVolcano
from repro.core import ir as RIR
from repro.core import preset as ref_preset
from repro.core.analysis import PlanInvariantError as RefPlanInvariantError
from repro.relational.queries import QUERIES as REF_QUERIES
from repro_torch.core import CompiledQuery, VolcanoEngine, preset
from repro_torch.core import expr as PE
from repro_torch.core import ir as PIR
from repro_torch.core.analysis import PlanInvariantError
from repro_torch.core.compile import (DEVICE_SELECT_ROWS, valid_rows_to_host,
                                   whole_to_host)
from repro_torch.core.operators import fused as fu
from repro_torch.kernels import codegen, ops
from repro_torch.relational import Database
from repro_torch.relational.queries import QUERIES
from repro_torch.relational.schema import ColKind, ColumnDef, TableSchema
from repro_torch.relational.table import Table
from test_queries import SORT_INSENSITIVE, assert_same
from test_torch_kernels import _columns, _host_eval, _values

RUNGS = ["naive", "template", "tpch", "strdict", "opt", "opt-pallas"]
ROW_RUNGS = ["naive", "opt", "opt-pallas"]
KERNELS = ["compact", "compact_pred", "selective_agg", "filter_agg"]
# kernel entry points the new joins' queries reach at opt-pallas (sf 0.01)
EXPECT_CALLS = {"q4": {"filter_agg": 1}, "q7": {"compact": 2},
                "q9full": {"filter_agg": 1}}


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
def oracle(db):
    eng = RefVolcano(db)
    return {q: eng.execute(REF_QUERIES[q]()) for q in sorted(REF_QUERIES)}


def test_every_query_is_on_the_ladder():
    assert sorted(QUERIES) == sorted(REF_QUERIES) and len(QUERIES) == 15


@pytest.mark.parametrize("pname", RUNGS)
@pytest.mark.parametrize("qname", sorted(REF_QUERIES))
def test_ladder_matches_oracle(pdb, oracle, qname, pname):
    cq = CompiledQuery(QUERIES[qname](), pdb, preset(pname), device="cpu")
    assert_same(cq.run(), oracle[qname], qname in SORT_INSENSITIVE)
    assert cq.n_overflows == 0


def test_template_stages_the_tpch_program(pdb):
    """Eager torch has no fusion scope to cut: `template` differs from
    `tpch` in `fusion` alone, and stages the same optimized plan."""
    t, c = preset("template"), preset("tpch")
    assert dataclasses.replace(t, fusion=True) == c
    for q in ("q3", "q13"):
        a = CompiledQuery(QUERIES[q](), pdb, t, device="cpu")
        b = CompiledQuery(QUERIES[q](), pdb, c, device="cpu")
        assert PIR.plan_repr(a.plan) == PIR.plan_repr(b.plan)
        assert set(a.inputs) == set(b.inputs)


@pytest.mark.parametrize("pname", ["naive", "opt-pallas"])
@pytest.mark.parametrize("qname", ["q1", "q9", "q13"])
def test_result_copies_agree(pdb, qname, pname):
    """`run()`'s two ways to bring a result to the host (the valid rows
    selected on the device above `DEVICE_SELECT_ROWS`, the whole frame
    below) give the same rows; no sf 0.01 frame reaches the cut."""
    cq = CompiledQuery(QUERIES[qname](), pdb, preset(pname), device="cpu")
    out, mask, _ = cq.execute(cq.bind())
    assert mask.shape[0] <= DEVICE_SELECT_ROWS
    (a, am), (b, bm) = (copy(out, mask) for copy in (valid_rows_to_host,
                                                     whole_to_host))
    assert am.all() and am.shape[0] == int(bm.sum())
    for k in a:
        np.testing.assert_array_equal(a[k], b[k][bm], err_msg=k)


# -- the new joins against the reference's compiled engine ------------------

def _ref_run(q, db, pname):
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
    return cq, res, calls


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
@pytest.mark.parametrize("qname", sorted(EXPECT_CALLS))
def test_new_joins_match_reference_compiled(db, pdb, qname, pname):
    before = dict(ops.calls)
    cq = CompiledQuery(QUERIES[qname](), pdb, preset(pname), device="cpu")
    got = cq.run()
    calls = {k: ops.calls[k] - before[k] for k in KERNELS}
    ref_cq, want, ref_calls = _ref_run(qname, db, pname)
    assert_same(got, want, qname in SORT_INSENSITIVE)
    assert set(cq.inputs) == set(ref_cq.inputs)
    for k, v in ref_cq.inputs.items():
        assert cq.inputs[k].shape == np.asarray(v).shape, k
    assert calls == ref_calls
    expect = EXPECT_CALLS[qname] if pname == "opt-pallas" else {}
    assert calls == {**dict.fromkeys(KERNELS, 0), **expect}


# -- the port's own Volcano engine (the dbx rung) ----------------------------

@pytest.mark.parametrize("qname", sorted(REF_QUERIES))
def test_port_volcano_matches_reference_volcano(pdb, oracle, qname):
    got = VolcanoEngine(pdb).execute(QUERIES[qname]())
    assert_same(got, oracle[qname], qname in SORT_INSENSITIVE)


# -- the row layout -----------------------------------------------------------

def row_settings(pname: str):
    return dataclasses.replace(preset(pname), layout="row")


@pytest.mark.parametrize("pname", ROW_RUNGS)
@pytest.mark.parametrize("qname", sorted(REF_QUERIES))
def test_row_layout_matches_oracle(pdb, oracle, qname, pname):
    cq = CompiledQuery(QUERIES[qname](), pdb, row_settings(pname),
                       device="cpu")
    assert_same(cq.run(), oracle[qname], qname in SORT_INSENSITIVE)


def test_row_layout_columns_are_views_of_the_records(pdb):
    """Each numeric column of a row-layout scan reads through its record
    matrix: a strided view.  q6's scan (its shipdate bound went to the
    date index) holds the float group alone."""
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.operators import StageCtx

    cq = CompiledQuery(QUERIES["q6"](), pdb, row_settings("opt-pallas"),
                       device="cpu")
    mats = sorted(k for k in cq.inputs if "/rowmat/" in k)
    assert [k.split("/")[2] for k in mats] == ["float"]
    scan = next(n for n in PIR.walk(cq.plan) if isinstance(n, PIR.Scan))
    inputs = {k: torch.from_numpy(v) for k, v in cq.inputs.items()}
    ctx = StageCtx(pdb, cq.settings, TorchBackend("cpu"),
                   lambda key, make: inputs[key], device="cpu", staged=True)
    frame = ctx.stage(scan)
    for name in ("l_discount", "l_quantity", "l_extendedprice"):
        arr = frame.cols[name].arr
        assert not arr.is_contiguous() and arr.stride(0) == 3, name


def _wide_key_db() -> Database:
    """One table whose INT key exceeds float32's exact-integer range:
    16777217 = 2^24 + 1 is the first integer float32 cannot represent."""
    schema = TableSchema("t", [ColumnDef("k", ColKind.INT),
                               ColumnDef("d", ColKind.DATE),
                               ColumnDef("v", ColKind.FLOAT)])
    k = np.array([16777215, 16777216, 16777217, 16777219, 7],
                 dtype=np.int32)
    d = np.array([20089, 20090, 20091, 20092, 20093], dtype=np.int32)
    v = np.array([1.5, 2.5, 3.5, 4.5, 5.5], dtype=np.float32)
    t = Table(schema, len(k), {"k": k, "d": d, "v": v})
    t.compute_stats()
    return Database({"t": t})


@pytest.mark.parametrize("pname", ROW_RUNGS)
def test_row_layout_int_exact_above_2p24(pname):
    plan = PIR.Agg(PIR.Select(PIR.Scan("t"),
                              PE.Cmp("==", PE.col("k"), PE.lit(16777217))),
                   [], [PIR.AggSpec("hits", "count"),
                        PIR.AggSpec("vsum", "sum", PE.col("v"))])
    res = CompiledQuery(plan, _wide_key_db(), row_settings(pname),
                        device="cpu").run()
    # through a float32 record matrix 16777217 would snap to 16777216 and
    # the equality probe would match no row
    assert int(res["hits"][0]) == 1
    np.testing.assert_allclose(float(res["vsum"][0]), 3.5, rtol=1e-6)


@pytest.mark.parametrize("pname", ROW_RUNGS)
def test_row_layout_roundtrips_wide_ints(pname):
    def plan(ir, X):
        return ir.Sort(ir.Select(ir.Scan("t"),
                                 X.Cmp(">", X.col("k"), X.lit(0))),
                       [("k", True)])

    db = _wide_key_db()
    res = CompiledQuery(plan(PIR, PE), db, row_settings(pname),
                        device="cpu").run()
    np.testing.assert_array_equal(
        res["k"], np.array([7, 16777215, 16777216, 16777217, 16777219],
                           dtype=np.int32))
    assert_same(res, VolcanoEngine(db).execute(plan(PIR, PE)), False)


def test_generated_source_reads_strided_columns(tmp_path):
    """Columns that are views into record matrices (stride 3 floats, 4
    ints) bake their strides into the generated loads; compiled as host
    C++, the functor gives the plain evaluator's predicate, group index
    and values bit for bit.  Contiguous columns emit the source they
    always did."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to build the generated source")
    n = 3000
    base = _columns(n, seed=5)
    fnames, inames = ["f0", "f1"], ["c0", "i0", "i1", "k0"]
    fmat = np.stack([base[c] for c in fnames]
                    + [np.zeros(n, np.float32)], 1)          # (n, 3)
    imat = np.stack([base[c] for c in inames], 1)            # (n, 4)
    tcols, host = {}, {}
    for names, mat in ((fnames, fmat), (inames, imat)):
        tm = torch.from_numpy(mat)
        flat = mat.reshape(-1)
        for j, c in enumerate(names):
            tcols[c] = tm[:, j]
            # the bytes the kernel's pointer sees: the records from
            # column j's first element on
            host[c] = np.concatenate([flat[j:], np.zeros(j, flat.dtype)]
                                     ).reshape(mat.shape)
    pred = PE.And(PE.Cmp(">=", PE.col("f0"), PE.Param("pf", "float32")),
                  PE.Or(PE.CodeIn("c0", (1, 3)),
                        PE.Cmp("<", PE.col("i0"), PE.col("i1"))))
    values = _values(PE)
    radix = [("c0", 7, 3), ("k0", 3, 1)]
    names = sorted(tcols)
    tcols = {c: tcols[c] for c in names}
    host = {c: host[c] for c in names}
    scalars = [0.05]
    em = codegen.emitter(tcols, ["pf"], scalars)
    src = codegen.functor_source(em, pred, values, radix, 21)
    # c0 is the codes column (an int record of 4), c1 is f0 (a float of 3)
    assert "c0[i * 4LL]" in src and "c1[i * 3LL]" in src
    fp, ip = codegen.split_scalars(["pf"], scalars)
    p, g, v = _host_eval(tmp_path, codegen.emitter(tcols, ["pf"], scalars),
                         pred, values, radix, 21, host, fp, ip)
    np.testing.assert_array_equal(p, fu.TileFn(pred, ["pf"])(tcols, scalars)
                                  .numpy())
    np.testing.assert_array_equal(g, fu.GroupIndex(radix, 21)(tcols,
                                                              scalars))
    for k, e in enumerate(values):
        want = torch.as_tensor(fu.TileFn(e, ["pf"])(tcols, scalars))
        np.testing.assert_array_equal(
            v[:, k], want.to(torch.float32).expand(n).numpy())
    contiguous = {c: t.contiguous() for c, t in tcols.items()}
    legacy = codegen.Emitter(codegen.column_types(contiguous),
                             codegen.param_types(["pf"], scalars))
    assert codegen.compact_pred_source(
        pred, codegen.emitter(contiguous, ["pf"], scalars)) == \
        codegen.compact_pred_source(pred, legacy)
    assert codegen.operand_key(tcols, ["pf"], scalars) != \
        codegen.operand_key(contiguous, ["pf"], scalars)


# -- the composite-key pack bound -------------------------------------------

def _composite_plan(ir):
    return ir.Agg(ir.Join(ir.Scan("lineitem"), ir.Scan("partsupp"),
                          "l_partkey", "ps_partkey",
                          stream_key2="l_suppkey", build_key2="ps_suppkey"),
                  [], [ir.AggSpec("n", "count")])


def test_composite_pack_past_2p32_raises_in_both_packages(db, pdb):
    """A hand-built generic composite join whose pack k1 * K2 + k2 would
    pass 2^32 is refused at staging (the verifier is off, so staging's
    own check is what refuses it) by the reference and by the port."""
    for database, run, err in (
            (db, lambda d, s: RefCompiledQuery(_composite_plan(RIR), d, s),
             RefPlanInvariantError),
            (pdb, lambda d, s: CompiledQuery(_composite_plan(PIR), d, s,
                                             device="cpu"),
             PlanInvariantError)):
        ps = database.table("partsupp").stats["ps_partkey"]
        li = database.table("lineitem").stats["l_partkey"]
        old = ps.max, li.max
        try:
            ps.max = li.max = 2 ** 31
            settings = dataclasses.replace(
                ref_preset("naive") if database is db else preset("naive"),
                verify_passes=False)
            with pytest.raises(err) as ei:
                run(database, settings)
            assert ei.value.rule == "key-pack"
        finally:
            ps.max, li.max = old
    # at the real bounds both compile and count every matched pair
    want = RefVolcano(db).execute(_composite_plan(RIR))
    got = CompiledQuery(copy.deepcopy(_composite_plan(PIR)), pdb,
                        preset("naive"), device="cpu").run()
    assert_same(got, want, False)
