"""The port's kernel entry points on the CPU (their plain torch versions)
against the reference's Pallas kernels in interpret mode, on the same
seeded numpy inputs, plus the CUDA source generator.

Predicates are built as the same `Expr` in both packages; the JAX side
evaluates them through `repro.core.operators.fused.make_tile_fn`.
Tolerances: integer outputs exact; float sums rtol 1e-5, atol 1e-4.
"""
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.expr as RE
import repro_torch.core.expr as PE
from repro.core.operators import fused as ref_fused
from repro.kernels import ops as ref_ops
from repro_torch.core import ir, optimize, preset
from repro_torch.core.operators import fused as fu
from repro_torch.kernels import codegen, ops
from repro_torch.kernels.build import CSRC
from repro_torch.relational import Database
from repro_torch.relational.queries import QUERIES

RTOL, ATOL = 1e-5, 1e-4


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _columns(n: int, seed: int) -> dict:
    """Seeded columns shaped like the engine's: f0 holds TPC-H discounts
    (k/100 in float32, so 0.05 and 0.07 occur exactly), f1 quantities,
    i0/i1 positive ints, d0 dates (days since 1970), c0/k0 codes."""
    rng = np.random.default_rng(seed)
    return {
        "c0": rng.integers(0, 7, n).astype(np.int32),
        "d0": rng.integers(8000, 10600, n).astype(np.int32),
        "f0": (rng.integers(0, 11, n) / 100.0).astype(np.float32),
        "f1": rng.integers(1, 51, n).astype(np.float32),
        "i0": rng.integers(1, 100, n).astype(np.int32),
        "i1": rng.integers(1, 100, n).astype(np.int32),
        "k0": rng.integers(0, 3, n).astype(np.int32),
    }


PARAMS = {"pf": ("float32", 17.5), "pi": ("int32", 40)}


def _preds(E) -> dict:
    """Kernel-safe predicates, spelled with package `E`'s Expr nodes."""
    col, lit = E.Col, E.Const
    return {
        "q6like": E.And(E.And(E.Cmp(">=", col("f0"), lit(0.05)),
                              E.Cmp("<=", col("f0"), lit(0.07))),
                        E.Cmp("<", col("f1"), lit(24.0))),
        "codes": E.Or(E.And(E.CodeIn("c0", (1, 3)),
                            E.Cmp("<", col("i0"), col("i1"))),
                      E.Not(E.CodeRange("c0", 2, 5))),
        "params": E.And(E.Cmp("<=", col("f1"), E.Param("pf", "float32")),
                        E.Cmp(">", col("i0"), E.Param("pi", "int32"))),
        "where": E.Cmp(">", E.Where(E.CodeEq("c0", 2),
                                    E.Arith("*", col("f0"), col("f1")),
                                    E.Arith("-", col("f1"), lit(3))),
                       lit(10.5)),
        "year": E.And(E.Cmp("==", E.Year(col("d0")), lit(1995)),
                      E.CodeEq("c0", 1, negate=True)),
        "div": E.Cmp("<", E.Arith("/", col("i0"), col("i1")), lit(0.5)),
        "const": lit(True),
    }


def _values(E) -> list:
    col = E.Col
    return [E.Arith("*", col("f0"), col("f1")), col("i0"),
            E.Where(E.CodeIn("c0", (0, 1)), E.Const(1.0), E.Const(0.0))]


def _pnames(e) -> list:
    return [p.name for p in fu.expr_params(e)]


def _operands(cols_np: dict, names: list, pnames: list):
    """(jax cols, jax scalars, port cols, port scalars) for `names`."""
    jcols = {k: jnp.asarray(cols_np[k]) for k in names}
    tcols = {k: T(cols_np[k]) for k in names}
    jsc = [jnp.asarray(PARAMS[p][1], dtype=PARAMS[p][0]) for p in pnames]
    tsc = [np.asarray(PARAMS[p][1], dtype=PARAMS[p][0]).item()
           for p in pnames]
    return jcols, jsc, tcols, tsc


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 37, 5000])
@pytest.mark.parametrize("cap", [8, 512])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact_matches_pallas(n, cap, p):
    """count 0 (p=0), overflow above cap (p=1 with n > cap), ragged tiles."""
    rng = np.random.default_rng(n * 7 + cap + int(p * 10))
    mask = rng.random(n) < p
    idx, count = ops.compact_query(T(mask), cap)
    widx, wcount = ref_ops.compact(jnp.asarray(mask), cap, interpret=True)
    assert int(count) == int(wcount) == int(mask.sum())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))


@pytest.mark.parametrize("n,cap", [(1, 8), (37, 16), (5000, 256)])
def test_compact_translate_matches_pallas(n, cap):
    rng = np.random.default_rng(n + cap)
    mask = rng.random(n) < 0.3
    idx, count, slot = ops.compact_query(T(mask), cap, translate=True)
    widx, wcount, wslot = ref_ops.compact(jnp.asarray(mask), cap,
                                              interpret=True, translate=True)
    assert int(count) == int(wcount)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(wslot))


@pytest.mark.parametrize("pred", sorted(_preds(PE)))
@pytest.mark.parametrize("n,cap,translate", [(1, 8, False), (37, 8, True),
                                             (5000, 4096, False),
                                             (5000, 64, True)])
def test_compact_pred_matches_pallas(pred, n, cap, translate):
    cols_np = _columns(n, seed=n + cap)
    pe, re_ = _preds(PE)[pred], _preds(RE)[pred]
    names = sorted(PE.expr_columns(pe)) or ["f0"]
    pnames = _pnames(pe)
    jcols, jsc, tcols, tsc = _operands(cols_np, names, pnames)
    got = ops.compact_pred_query(tcols, tsc, fu.TileFn(pe, pnames),
                                 cap, translate=translate)
    want = ref_ops.compact_pred(
        jcols, jsc, ref_fused.make_tile_fn(re_, pnames), cap,
        interpret=True, translate=translate)
    assert int(got[1]) == int(want[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if translate:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 37, 5000])
@pytest.mark.parametrize("n_groups", [1, 6, 130])
@pytest.mark.parametrize("n_vals", [1, 3])
def test_filter_agg_matches_pallas(n, n_groups, n_vals):
    rng = np.random.default_rng(n * 1000 + n_groups + n_vals)
    mask = rng.random(n) < 0.6
    gidx = rng.integers(0, n_groups, n).astype(np.int32)
    vals = [rng.normal(size=n).astype(np.float32) for _ in range(n_vals)]
    sums, counts = ops.filter_agg_query(T(mask), T(gidx),
                                        [T(v) for v in vals], n_groups)
    wsums, wcounts = ref_ops.filter_agg_query(
        jnp.asarray(mask), jnp.asarray(gidx), [jnp.asarray(v) for v in vals],
        n_groups, interpret=True)
    np.testing.assert_allclose(sums.numpy(), np.asarray(wsums),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wcounts))


def test_filter_agg_all_false_mask():
    n = 300
    gidx = np.zeros(n, np.int32)
    sums, counts = ops.filter_agg_query(
        T(np.zeros(n, bool)), T(gidx), [T(np.ones(n, np.float32))], 4)
    assert not sums.any() and not counts.any()


def test_filter_agg_query_counts_past_2_24():
    """2^24 + 3 valid rows in one group count 16,777,219, as int32: the
    engine's count is exact where a float32 count (the reference's ones
    column) stops at 2^24."""
    n = (1 << 24) + 3
    sums, counts = ops.filter_agg_query(
        torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
        [], 1)
    assert counts.dtype == torch.int32 and sums.shape == (1, 0)
    assert int(counts[0]) == 16_777_219
    assert float(np.float32(n)) != n      # what a float32 count would lose


@pytest.mark.parametrize("pred", ["q6like", "codes", "params", "year",
                                  "const"])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("n", [1, 37, 5000])
def test_selective_agg_matches_pallas(pred, grouped, n):
    cols_np = _columns(n, seed=3 * n + len(pred))
    pe, re_ = _preds(PE)[pred], _preds(RE)[pred]
    pv, rv = _values(PE), _values(RE)
    radix = [("c0", 7, 3), ("k0", 3, 1)] if grouped else []
    G = 21 if grouped else 1
    names = set(PE.expr_columns(pe)) | {g for g, _, _ in radix}
    for e in pv:
        names |= PE.expr_columns(e)
    names = sorted(names)
    pnames = []
    for e in [pe] + pv:
        pnames += [p for p in _pnames(e) if p not in pnames]
    jcols, jsc, tcols, tsc = _operands(cols_np, names, pnames)
    gidx = fu.GroupIndex(radix, G) if grouped else None
    sums, counts, total = ops.selective_agg_query(
        tcols, tsc, fu.TileFn(pe, pnames),
        [fu.TileFn(e, pnames) for e in pv], gidx, G)

    def jgidx(cols, _s):
        idx = cols["c0"].astype(jnp.int32) * 3 + cols["k0"].astype(jnp.int32)
        return jnp.clip(idx, 0, G - 1)

    wsums, wcounts, wtotal = ref_ops.selective_agg_query(
        jcols, jsc, ref_fused.make_tile_fn(re_, pnames),
        [ref_fused.make_tile_fn(e, pnames) for e in rv],
        jgidx if grouped else None, G, interpret=True)
    assert int(total) == int(wtotal)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(wsums),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the CUDA source generator
# ---------------------------------------------------------------------------

_NUM = re.compile(r"(?<![\w.])(\d+\.\d*(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)(f?)")


def _float_literals(src: str) -> list[tuple[str, str]]:
    return _NUM.findall(src)


@pytest.fixture(scope="module")
def tdb():
    return Database.tpch(sf=0.01, seed=0)


def _fused_preds(db, qname):
    """The predicates the opt-pallas plan of `qname` hands to a kernel."""
    plan = optimize(QUERIES[qname](), db, preset("opt-pallas"))
    return [n.child.pred for n in ir.walk(plan)
            if isinstance(n, (ir.Agg, ir.Compact))
            and isinstance(n.child, ir.Select)
            and fu.elementwise_chain(n.child.child)
            and fu.kernel_safe(n.child.pred)]


@pytest.mark.parametrize("qname,expect", [
    ("q6", ["0.05f", "0.07f", "24.0f"]), ("q12", [])])
def test_codegen_float_literals_are_float32(tdb, qname, expect):
    preds = _fused_preds(tdb, qname)
    assert preds, f"{qname}'s opt-pallas plan fuses no predicate"
    for pred in preds:
        names = sorted(PE.expr_columns(pred))
        t = tdb.table("lineitem")
        em = codegen.Emitter(
            {c: "float" if t.data[c].dtype == np.float32 else "int"
             for c in names}, {})
        src = codegen.compact_pred_source(pred, em)
        lits = _float_literals(src)
        assert all(suffix == "f" for _, suffix in lits), lits
        for want in expect:
            assert want in src


def test_float_literal_round_trips_float32():
    rng = np.random.default_rng(0)
    for v in list(rng.normal(size=200) * 10.0 ** rng.integers(-30, 30, 200)) \
            + [0.07, 0.05, 24.0, 1.0, 3.0e38, -0.0, 1e-45]:
        lit = codegen.float_literal(v)
        assert lit.endswith("f")
        assert np.float32(lit[:-1]) == np.float32(v)


def _every_node_pred(E):
    """One predicate holding every node kind of fused._SAFE."""
    col = E.Col
    return E.Or(
        E.And(E.Cmp("<", E.Arith("/", col("i0"), col("i1")),
                    E.Param("pf", "float32")),
              E.Not(E.CodeIn("c0", (1, 4)))),
        E.And(E.Cmp("==", E.Year(col("d0")), E.Param("pi", "int32")),
              E.Or(E.CodeEq("c0", 2),
                   E.And(E.CodeRange("c0", 3, 6),
                         E.Cmp(">", E.Where(E.Cmp(">", col("f0"),
                                                  E.Const(0.04)),
                                            E.Arith("+", col("f1"),
                                                    E.Const(1.5)),
                                            E.Arith("-", col("i0"),
                                                    E.Const(7))),
                               E.Const(20))))))


def test_codegen_covers_every_safe_node():
    pred = _every_node_pred(PE)
    seen = set()

    def walk(e):
        seen.add(type(e))
        for f in ("lhs", "rhs", "operand", "cond", "then", "other"):
            if hasattr(e, f):
                walk(getattr(e, f))
    walk(pred)
    assert seen == set(fu._SAFE)
    names = sorted(PE.expr_columns(pred))
    em = codegen.Emitter({c: "float" if c.startswith("f") else "int"
                          for c in names}, {"pf": "float", "pi": "int"})
    src = codegen.compact_pred_source(pred, em)
    for frag in ("repro::year_of_days(", " ? ", "(!", " || ", " && ",
                 " / ", "p0", "p1", "0.04f", "1.5f"):
        assert frag in src, frag
    assert all(suffix == "f" for _, suffix in _float_literals(src))


def _host_eval(tmp_path, em, pred, values, radix, n_groups, cols_np,
               fp, ip):
    """Compile the generated row functor as host C++ (g++) and evaluate
    it over `cols_np`: (pred bool[n], group int32[n], values f32[n, V])."""
    nv = len(values)
    fill = "\n".join(em.fill("s"))
    src = f"""
#include <cstdio>
#include <cstdint>
#include <vector>
#include "expr.cuh"
{codegen.functor_source(em, pred, values, radix, n_groups)}
int main(int argc, char** argv) {{
  FILE* f = fopen(argv[1], "rb");
  long long n; int ncols, nf, ni;
  if (fread(&n, 8, 1, f) != 1 || fread(&ncols, 4, 1, f) != 1 ||
      fread(&nf, 4, 1, f) != 1 || fread(&ni, 4, 1, f) != 1) return 2;
  std::vector<std::vector<char>> bufs(ncols);
  std::vector<const void*> colsv(ncols + 1);
  for (int k = 0; k < ncols; ++k) {{
    long long bytes;
    if (fread(&bytes, 8, 1, f) != 1) return 2;
    bufs[k].resize(bytes + 1);
    if (fread(bufs[k].data(), 1, bytes, f) != (size_t)bytes) return 2;
    colsv[k] = bufs[k].data();
  }}
  std::vector<double> fpv(nf + 1);
  std::vector<long long> ipv(ni + 1);
  if (fread(fpv.data(), 8, nf, f) != (size_t)nf) return 2;
  if (fread(ipv.data(), 8, ni, f) != (size_t)ni) return 2;
  const void* const* cols = colsv.data();
  const double* fp = fpv.data();
  const long long* ip = ipv.data();
  (void)cols; (void)fp; (void)ip;
  Src s{{}};
{fill}
  FILE* o = fopen(argv[2], "wb");
  for (long long i = 0; i < n; ++i) {{
    unsigned char p = s.pred(i);
    int g = s.group(i);
    float v[{nv} + 1];
    s.values(i, v);
    fwrite(&p, 1, 1, o);
    fwrite(&g, 4, 1, o);
    fwrite(v, 4, {nv}, o);
  }}
  fclose(o);
  return 0;
}}
"""
    (tmp_path / "h.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-I", str(CSRC), "-o", str(tmp_path / "h"),
                    str(tmp_path / "h.cpp")], check=True,
                   capture_output=True)
    n = next(iter(cols_np.values())).shape[0]
    with open(tmp_path / "in.bin", "wb") as fh:
        fh.write(np.int64(n).tobytes())
        fh.write(np.array([len(em.cols), len(fp), len(ip)], np.int32)
                 .tobytes())
        for c in em.cols:
            b = np.ascontiguousarray(cols_np[c]).tobytes()
            fh.write(np.int64(len(b)).tobytes() + b)
        fh.write(np.asarray(fp, np.float64).tobytes())
        fh.write(np.asarray(ip, np.int64).tobytes())
    subprocess.run([str(tmp_path / "h"), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True)
    rec = np.dtype([("p", np.uint8), ("g", np.int32),
                    ("v", np.float32, (nv,))])
    out = np.fromfile(tmp_path / "out.bin", dtype=rec)
    return out["p"].astype(bool), out["g"], out["v"].reshape(n, nv)


@pytest.mark.parametrize("pred", sorted(_preds(PE)) + ["every_node"])
def test_generated_source_matches_torch_evaluator(tmp_path, pred):
    """The emitted expression, compiled as host C++ with the float rules
    the kernels are built with (no FMA contraction), gives bit-identical
    predicates, group indices and values to the plain torch evaluator."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to build the generated source")
    n = 4000
    cols_np = _columns(n, seed=11)
    pe = _every_node_pred(PE) if pred == "every_node" else _preds(PE)[pred]
    values = _values(PE)
    radix = [("c0", 7, 3), ("k0", 3, 1)]
    names = set(PE.expr_columns(pe)) | {"c0", "k0"}
    for e in values:
        names |= PE.expr_columns(e)
    names = sorted(names)
    pnames = []
    for e in [pe] + values:
        pnames += [p for p in _pnames(e) if p not in pnames]
    _, _, tcols, tsc = _operands(cols_np, names, pnames)
    em = codegen.Emitter(codegen.column_types(tcols),
                         codegen.param_types(pnames, tsc))
    fp, ip = codegen.split_scalars(pnames, tsc)
    p, g, v = _host_eval(tmp_path, em, pe, values, radix, 21, cols_np,
                         fp, ip)
    want_p = fu.TileFn(pe, pnames)(tcols, tsc)
    want_p = torch.as_tensor(want_p).expand(n).numpy()
    np.testing.assert_array_equal(p, want_p)
    np.testing.assert_array_equal(g, fu.GroupIndex(radix, 21)(tcols, tsc))
    for k, e in enumerate(values):
        want = torch.as_tensor(fu.TileFn(e, pnames)(tcols, tsc))
        np.testing.assert_array_equal(
            v[:, k], want.to(torch.float32).expand(n).numpy())


# ---------------------------------------------------------------------------
# concurrency: a server's pool threads build and count at the same time
# ---------------------------------------------------------------------------

def test_build_load_builds_two_libraries_at_once(tmp_path, monkeypatch):
    """Two threads loading two new libraries run their two `nvcc`s side
    by side: the stub compiler waits until the other build has started,
    so a lock held across a whole build fails this test."""
    import sys
    import threading

    from repro_torch.kernels import build

    sync = tmp_path / "started"
    sync.mkdir()
    stub = tmp_path / "nvcc"
    stub.write_text(f"""#!{sys.executable}
import pathlib, sys, time
args = sys.argv[1:]
sync = pathlib.Path({str(sync)!r})
(sync / pathlib.Path(args[-1]).name).touch()
deadline = time.monotonic() + 20
while len(list(sync.iterdir())) < 2:
    if time.monotonic() > deadline:
        sys.exit("the other build never started")
    time.sleep(0.01)
pathlib.Path(args[args.index("-o") + 1]).write_bytes(b"")
""")
    stub.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(stub))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_BUILDING", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    loaded, errors = {}, []

    def load(name):
        try:
            loaded[name] = build.load(name, f"// {name}\n")
        except BaseException as e:     # reported below, on the test thread
            errors.append(e)

    threads = [threading.Thread(target=load, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert loaded["a"] != loaded["b"]
    assert sorted(p.name for p in sync.iterdir()) == sorted(
        build.library_path(n, f"// {n}\n").with_suffix(".cu").name
        for n in "ab")
    # a second load of a built library builds nothing
    assert build.load("a", "// a\n") == loaded["a"]
    assert len(list(sync.iterdir())) == 2


def test_engine_call_counts_are_exact_under_threads():
    """8 threads x 1,000 calls of an engine entry point count 8,000: the
    counters `chip_smoke.py` reads lose no increment under threads."""
    import sys
    import threading

    mask = torch.tensor([True, False, True])
    before = ops.calls["compact"]

    def work():
        for _ in range(1000):
            ops.compact_query(mask, 4)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert ops.calls["compact"] - before == 8000
