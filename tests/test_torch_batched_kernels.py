"""The engine kernels' batched forms (the bind-many pass) on the CPU, at
small seeded shapes:

  * each batched plain version (`compact_batched`, `compact_pred_batched`,
    `filter_agg_batched`, `selective_filter_agg_batched`: on CPU tensors
    the batched plain versions) against `jax.vmap` of the reference's
    Pallas kernel in interpret mode (`repro.kernels.ops`, as the
    reference's engine vmaps it at `opt-pallas`) and against the scalar
    plain version binding by binding;
  * every pattern of batched and shared operands (vmap decides which
    operands carry the binding axis), B = 1, a binding with no valid row,
    one over the capacity, and translate;
  * the engine's custom operators under `torch.func.vmap`: one call of
    each per call site for B bindings, its vmap rule the batched form,
    and an op with no batched operand the scalar call once;
  * the batched instances' generated sources, and their library keys
    apart from the scalar instances'.

vmap's per-example fallback is off in this module, so an op without a
batching rule fails instead of looping.  Tolerances: integer outputs
exact; float sums rtol 1e-5, atol 1e-4 (as `test_torch_kernels`).
"""
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.expr as RE
import repro_torch.core.expr as PE
from repro.core.operators import fused as ref_fused
from repro.kernels import ops as ref_ops
from repro_torch.core.operators import fused as fu
from repro_torch.kernels import build, codegen, ops
from test_torch_kernels import (ATOL, RTOL, T, _columns, _pnames, _preds,
                                _values)

kc = importlib.import_module("repro_torch.kernels.compact")
kf = importlib.import_module("repro_torch.kernels.filter_agg")


@pytest.fixture(scope="module", autouse=True)
def no_vmap_fallback():
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)


def _masks(B: int, n: int, seed: int) -> np.ndarray:
    """B masks: binding 0 has no valid row, binding 1 every row (over a
    small capacity), the rest about 30 %."""
    rng = np.random.default_rng(seed)
    m = rng.random((B, n)) < 0.3
    m[0] = False
    if B > 1:
        m[1] = True
    return m


def _ax(batched: bool):
    return 0 if batched else None


def _same_ints(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_floats(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _per_binding(batched_out, scalar_fn, B):
    """Slot b of every batched output against the scalar plain version on
    binding b's operands."""
    for b in range(B):
        for g, w in zip(batched_out, scalar_fn(b)):
            if g.dtype.is_floating_point:
                assert torch.equal(g[b], w), b
            else:
                assert torch.equal(g[b], w.to(g.dtype)), b


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("translate", [False, True])
@pytest.mark.parametrize("n,cap", [(37, 8), (600, 64)])
@pytest.mark.parametrize("B", [1, 4])
def test_compact_batched_matches_vmapped_pallas(B, n, cap, translate):
    mask = _masks(B, n, seed=B * 100 + n + cap)
    got = kc.compact_batched(T(mask), cap, translate=translate)
    want = jax.vmap(lambda m: ref_ops.compact(m, cap, interpret=True,
                                              translate=translate))(
        jnp.asarray(mask))
    assert len(got) == len(want) == (3 if translate else 2)
    for g, w in zip(got, want):
        _same_ints(g.numpy(), w)
    assert got[0].shape == (B, cap) and got[1].shape == (B,)
    _same_ints(got[1].numpy(), mask.sum(1))
    _per_binding(got, lambda b: kc.compact_plain(T(mask[b]), cap, translate),
                 B)


_PRED_COLS = ["f1", "i0"]


def _pred_case(B: int, n: int, cols_batched, params_batched, seed: int):
    """(numpy columns (B, n) or (n,), numpy params (B,) or ()): the
    "params" predicate of test_torch_kernels, f1 <= pf and i0 > pi."""
    rng = np.random.default_rng(seed)
    base = _columns(n, seed)
    cols = {}
    for name, b in zip(_PRED_COLS, cols_batched):
        cols[name] = np.stack([_columns(n, seed + 1 + k)[name]
                               for k in range(B)]) if b else base[name]
    pf = (rng.integers(5, 45, B) + 0.5).astype(np.float32) \
        if params_batched else np.float32(17.5)
    pi = rng.integers(10, 90, B).astype(np.int32) \
        if params_batched else np.int32(40)
    return cols, [pf, pi]


_PATTERNS_2 = [p for p in itertools.product([False, True], repeat=3)
               if any(p)]


@pytest.mark.parametrize("translate", [False, True])
@pytest.mark.parametrize("pattern", _PATTERNS_2,
                         ids=lambda p: "".join("b" if x else "s" for x in p))
def test_compact_pred_batched_matches_vmapped_pallas(pattern, translate):
    """pattern: f1, i0 and the two parameters, batched (b) or shared (s)."""
    B, n, cap = 3, 700, 128
    cols_b, params_b = pattern[:2], pattern[2]
    cols, params = _pred_case(B, n, cols_b, params_b, seed=sum(pattern))
    pe, re_ = _preds(PE)["params"], _preds(RE)["params"]
    pnames = _pnames(pe)
    tparams = [torch.from_numpy(np.asarray(p)) if params_b else p.item()
               for p in params]
    fp, ip, kinds = kc.param_vectors(tparams)
    tcols = {k: T(v) for k, v in cols.items()}
    got = kc.compact_pred_batched(tcols, fp, ip, kinds,
                                  fu.TileFn(pe, pnames), cap,
                                  translate=translate)
    want = jax.vmap(
        lambda c, s: ref_ops.compact_pred(
            c, s, ref_fused.make_tile_fn(re_, pnames), cap,
            translate=translate, interpret=True),
        in_axes=({k: _ax(b) for k, b in zip(_PRED_COLS, cols_b)},
                 [_ax(params_b)] * 2))(
        {k: jnp.asarray(v) for k, v in cols.items()},
        [jnp.asarray(p) for p in params])
    for g, w in zip(got, want):
        _same_ints(g.numpy(), w)

    def scalar(b):
        return kc.compact_pred_plain(
            {k: kc.binding(v, b, 1) for k, v in tcols.items()},
            kc.binding_scalars(fp, ip, kinds, b), fu.TileFn(pe, pnames), cap,
            translate)
    _per_binding(got, scalar, B)


def test_param_vectors_round_trip():
    """Each binding's scalars come back from the vectors as the scalar
    walk has them: floats as float32 values, ints and bools."""
    vals = [torch.tensor([1.5, 2.25]), torch.tensor([3, 4], dtype=torch.int32),
            torch.tensor([True, False])]
    fp, ip, kinds = kc.param_vectors(vals)
    assert kinds == ("float", "int", "bool")
    assert fp.shape == (2, 1) and ip.shape == (2, 2)
    assert kc.binding_scalars(fp, ip, kinds, 1) == [2.25, 4, False]
    fp, ip, kinds = kc.param_vectors([0.1, 7])
    assert fp.shape == (1,) and ip.shape == (1,)
    assert kc.binding_scalars(fp, ip, kinds, 5) == [0.1, 7]


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

_PATTERNS_3 = [p for p in itertools.product([False, True], repeat=3)
               if any(p)]


@pytest.mark.parametrize("G,A", [(1, 1), (6, 3), (130, 2)])
@pytest.mark.parametrize("pattern", _PATTERNS_3,
                         ids=lambda p: "".join("b" if x else "s" for x in p))
def test_filter_agg_batched_matches_vmapped_pallas(pattern, G, A):
    """pattern: mask, gidx and the value columns, batched (b) or shared
    (s) — q1's call has a batched mask beside shared gidx and values,
    q12's every operand batched."""
    B, n = 3, 500
    rng = np.random.default_rng(G * 10 + A + sum(pattern))
    mb, gb, vb = pattern
    mask = rng.random((B, n) if mb else n) < 0.6
    if mb:
        mask[0] = False
    gidx = rng.integers(-1, G + 1, (B, n) if gb else n).astype(np.int32)
    vals = [rng.normal(size=(B, n) if vb else n).astype(np.float32)
            for _ in range(A)]
    got = kf.filter_agg_batched(T(mask), T(gidx), [T(v) for v in vals], G)
    # the reference counts out-of-range groups nowhere as well: its
    # oracle's one-hot drops them
    want = jax.vmap(
        lambda m, g, v: ref_ops.filter_agg_query(m, g, v, G, interpret=True),
        in_axes=(_ax(mb), _ax(gb), [_ax(vb)] * A))(
        jnp.asarray(mask), jnp.asarray(gidx), [jnp.asarray(v) for v in vals])
    assert got[0].shape == (B, G, A) and got[1].shape == (B, G)
    _same_floats(got[0].numpy(), want[0])
    _same_ints(got[1].numpy(), want[1])

    def scalar(b):
        return kf.filter_agg_plain(
            kc.binding(T(mask), b, 1), kc.binding(T(gidx), b, 1),
            [kc.binding(T(v), b, 1) for v in vals], G)
    _per_binding(got, scalar, B)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("pattern", [(True, False), (False, True),
                                     (True, True)],
                         ids=["cols", "params", "both"])
def test_selective_batched_matches_vmapped_pallas(pattern, grouped):
    """pattern: the columns and the parameters, batched or shared."""
    B, n = 3, 600
    cols_b, params_b = pattern
    pe, re_ = _preds(PE)["params"], _preds(RE)["params"]
    pv, rv = _values(PE), _values(RE)
    radix = [("c0", 7, 3), ("k0", 3, 1)] if grouped else []
    G = 21 if grouped else 1
    names = set(PE.expr_columns(pe)) | {g for g, _, _ in radix}
    for e in pv:
        names |= PE.expr_columns(e)
    names = sorted(names)
    pnames = _pnames(pe)
    one = _columns(n, 11)
    cols = {k: np.stack([_columns(n, 12 + b)[k] for b in range(B)])
            if cols_b else one[k] for k in names}
    _c, params = _pred_case(B, n, (False, False), params_b, seed=5)
    tparams = [torch.from_numpy(np.asarray(p)) if params_b else p.item()
               for p in params]
    fp, ip, kinds = kc.param_vectors(tparams)
    gfn = fu.GroupIndex(radix, G) if grouped else None
    tcols = {k: T(v) for k, v in cols.items()}
    got = kf.selective_filter_agg_batched(
        tcols, fp, ip, kinds, fu.TileFn(pe, pnames),
        [fu.TileFn(e, pnames) for e in pv], gfn, G)

    def jgidx(c, _s):
        idx = c["c0"].astype(jnp.int32) * 3 + c["k0"].astype(jnp.int32)
        return jnp.clip(idx, 0, G - 1)

    want = jax.vmap(
        lambda c, s: ref_ops.selective_agg_query(
            c, s, ref_fused.make_tile_fn(re_, pnames),
            [ref_fused.make_tile_fn(e, pnames) for e in rv],
            jgidx if grouped else None, G, interpret=True),
        in_axes=({k: _ax(cols_b) for k in names}, [_ax(params_b)] * 2))(
        {k: jnp.asarray(v) for k, v in cols.items()},
        [jnp.asarray(p) for p in params])
    _same_floats(got[0].numpy(), want[0])
    _same_ints(got[1].numpy(), want[1])
    _same_ints(got[2].numpy(), want[2])

    def scalar(b):
        return kf.selective_filter_agg_plain(
            {k: kc.binding(v, b, 1) for k, v in tcols.items()},
            kc.binding_scalars(fp, ip, kinds, b), fu.TileFn(pe, pnames),
            [fu.TileFn(e, pnames) for e in pv], gfn, G)
    _per_binding(got, scalar, B)


# ---------------------------------------------------------------------------
# the custom operators under vmap
# ---------------------------------------------------------------------------

def _count_batched(monkeypatch):
    """Count the calls of each batched form (the ops' vmap rules)."""
    seen = {}
    for mod, name in [(kc, "compact_batched_packed"),
                      (kc, "compact_pred_batched_packed"),
                      (kf, "filter_agg_batched_packed"),
                      (kf, "selective_filter_agg_batched_packed")]:
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            seen[_name] = seen.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return seen


def _engine_call(entry: str, n: int = 400):
    """(fn of a (B,) float32 parameter vector's element, the batched form
    it must reach): one engine entry point whose predicate or mask
    depends on the parameter."""
    cols = {k: T(v) for k, v in _columns(n, 3).items()}
    pe = PE.Cmp("<=", PE.Col("f1"), PE.Param("pf", "float32"))
    pred = fu.TileFn(pe, ["pf"])
    vals = [fu.TileFn(e, ["pf"]) for e in _values(PE)]
    if entry == "compact":
        return (lambda p: ops.compact_query(cols["f1"] <= p, 64,
                                            translate=True),
                "compact_batched_packed")
    if entry == "compact_pred":
        return (lambda p: ops.compact_pred_query(
            {"f1": cols["f1"]}, [p], pred, 64, translate=True),
            "compact_pred_batched_packed")
    if entry == "filter_agg":
        return (lambda p: ops.filter_agg_query(
            cols["f1"] <= p, cols["k0"], [cols["f0"], cols["f1"]], 3),
            "filter_agg_batched_packed")
    names = sorted({"f1", "c0", "k0", "i0", "f0"})
    return (lambda p: ops.selective_agg_query(
        {k: cols[k] for k in names}, [p], pred, vals,
        fu.GroupIndex([("c0", 7, 3), ("k0", 3, 1)], 21), 21),
        "selective_filter_agg_batched_packed")


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("entry", ["compact", "compact_pred", "filter_agg",
                                   "selective_agg"])
def test_engine_op_is_one_call_per_call_site(monkeypatch, entry, B):
    """Under vmap over B parameter values an entry point is called once,
    its custom op's vmap rule runs the batched form once, and slot b is
    the scalar call's on parameter b."""
    seen = _count_batched(monkeypatch)
    fn, form = _engine_call(entry)
    pvec = torch.tensor(np.linspace(4.0, 40.0, B), dtype=torch.float32)
    before = dict(ops.calls)
    got = torch.func.vmap(fn)(pvec)
    moved = {k: ops.calls[k] - before[k] for k in before}
    assert moved == {k: int(k == entry) for k in before}
    assert seen == {form: 1}
    for b in range(B):
        want = fn(float(pvec[b]))
        for g, w in zip(got, want):
            assert g.shape == (B, *w.shape)
            assert torch.equal(g[b], w), (entry, b)


@pytest.mark.parametrize("entry", ["compact", "compact_pred", "filter_agg",
                                   "selective_agg"])
def test_engine_op_without_batched_operand_runs_once(monkeypatch, entry):
    """A call under vmap whose operands vmap left unbatched is the scalar
    call once, its result every binding's."""
    seen = _count_batched(monkeypatch)
    fn, _form = _engine_call(entry)
    got = torch.func.vmap(lambda _p: fn(20.0))(torch.zeros(3))
    assert seen == {}
    for g, w in zip(got, fn(20.0)):
        assert all(torch.equal(g[b], w) for b in range(3))


def test_ops_called_directly_equal_the_entry_points():
    """Each custom operator called outside vmap (its implementation: the
    scalar call, packed) gives the entry point's outputs."""
    cols = {k: T(v) for k, v in _columns(400, 3).items()}
    pe = PE.Cmp("<=", PE.Col("f1"), PE.Param("pf", "float32"))
    pred, vals = fu.TileFn(pe, ["pf"]), [fu.TileFn(e, ["pf"])
                                         for e in _values(PE)]
    gfn = fu.GroupIndex([("c0", 7, 3), ("k0", 3, 1)], 21)
    names = sorted({"f1", "c0", "k0", "i0", "f0"})
    sub = {k: cols[k] for k in names}
    fp, ip, kinds = kc.param_vectors([20.0])
    kinds = ",".join(kinds)
    rop = torch.ops.repro_torch
    pairs = [
        (kc.unpack(rop.compact(cols["f1"] <= 20.0, 64, True), 64, True),
         ops.compact_query(cols["f1"] <= 20.0, 64, translate=True)),
        (kc.unpack(rop.compact_pred(ops._handle({"f1": 0}, pred),
                                    [cols["f1"]], fp, ip, kinds, 64, True),
                   64, True),
         ops.compact_pred_query({"f1": cols["f1"]}, [20.0], pred, 64,
                                translate=True)),
        (kf.agg_unpack(rop.filter_agg(cols["f1"] <= 20.0, cols["k0"],
                                      [cols["f0"]], 3), 3, 1)[:2],
         ops.filter_agg_query(cols["f1"] <= 20.0, cols["k0"], [cols["f0"]],
                              3)),
        (kf.agg_unpack(rop.selective_agg(
            ops._handle(sub, pred, vals, gfn, 21), list(sub.values()), fp,
            ip, kinds, 21), 21, len(vals)),
         ops.selective_agg_query(sub, [20.0], pred, vals, gfn, 21)),
    ]
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_entry_points_reach_the_ops():
    """Each engine entry point's custom operator is registered in the
    repro_torch namespace."""
    for name in ops.calls:
        assert getattr(torch.ops.repro_torch, name).default is not None


# ---------------------------------------------------------------------------
# the batched instances' generated sources
# ---------------------------------------------------------------------------

def test_batched_sources_read_bindings_apart():
    """The batched instances wrap the scalar functor in `Batch`: column
    pointers moved by their binding strides, parameters read from the
    device vectors at the binding's row; one memset and one launch."""
    pe = _preds(PE)["params"]
    pnames = _pnames(pe)
    cols = {k: T(_columns(8, 1)[k]) for k in sorted(PE.expr_columns(pe))}
    em = codegen.emitter(cols, pnames, ["float", "int"])
    src = codegen.compact_pred_batch_source(pe, em)
    assert "struct Batch" in src and "repro::compact_batch_into(bt, B" in src
    assert "r.p0 = (float)fp[(long long)b * fps + 0];" in src
    assert "r.p1 = (int)ip[(long long)b * ips + 0];" in src
    assert "r.c0 = s.c0 + (long long)b * cs[0];" in src
    vals = _values(PE)
    names = set(PE.expr_columns(pe)) | {"k0"}
    for e in vals:
        names |= PE.expr_columns(e)
    em = codegen.emitter({k: T(_columns(8, 1)[k]) for k in sorted(names)},
                         pnames, ["float", "int"])
    src = codegen.selective_agg_batch_source(pe, vals, [("k0", 3, 1)], 3, em)
    assert "repro::launch_agg_batch<Batch, 3, 3>(" in src
    # the scalar instance is what it was
    scalar = codegen.compact_pred_source(pe, em)
    assert "struct Batch" not in scalar and "compact_into(s, n, ws" in scalar


def test_batched_instance_is_a_library_of_its_own(monkeypatch):
    """The batched and the scalar instance of one predicate are two
    libraries, each generated once."""
    loaded = []

    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "load",
                        lambda name, src: loaded.append(name) or Lib())
    monkeypatch.setattr(kc, "_PRED_LIBS", {})
    pe = _preds(PE)["params"]
    pnames = _pnames(pe)
    cols = {k: T(_columns(8, 1)[k]) for k in sorted(PE.expr_columns(pe))}
    pred = fu.TileFn(pe, pnames)
    for _ in range(2):
        kc._pred_lib(cols, [17.5, 40], pred)
        kc._pred_batch_lib(cols, ("float", "int"), pred)
    assert loaded == ["compact_pred", "compact_pred_batched"]
    assert len(kc._PRED_LIBS) == 2


def test_batch_workspace_rows_stay_aligned():
    """Each binding's compaction row is the scalar layout padded to a
    quad, so its 8-byte status words stay aligned."""
    for n, cap, tr in [(0, 1, False), (37, 3, True), (5000, 64, False),
                       ((1 << 20) + 1, 7, True)]:
        w = kc.row_words(n, cap, tr)
        assert w % 4 == 0
        assert w >= kc.workspace_head(n) + cap + (n if tr else 0)
        ws = kc._batch_workspace(3, n, cap, tr, torch.device("cpu"))
        packed = kc._packed_view(ws, n, cap, tr)
        assert ws.shape == (3, w)
        assert packed.shape == (3, 1 + cap + (n if tr else 0))
