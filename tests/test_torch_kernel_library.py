"""The port's kernel library surface (`repro_torch.kernels`) on the CPU,
where each entry point runs its plain torch version, against the
reference's `repro.kernels` (Pallas kernels in interpret mode, as
`tests/test_kernels.py` runs them) and its `ref` oracles, on the same
seeded numpy inputs.

Tolerances: gathers, top-k values and ids, row ids, counts and slots are
exact; float sums rtol 1e-5, atol 1e-4 (`test_torch_kernels.RTOL/ATOL`:
the two packages add in different orders).
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.expr as RE
import repro.kernels as RK
import repro_torch.kernels as PK
from repro.core.operators import fused as ref_fused
from repro_torch.core import expr as PE
from repro_torch.core.operators import fused as fu
from repro_torch.kernels import build, codegen
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.topk import MAX_K
from test_torch_kernels import (ATOL, RTOL, T, _columns, _operands, _pnames,
                                _preds, _values)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_surface_exports_every_reference_name():
    assert set(RK.__all__) <= set(PK.__all__)
    for name in RK.__all__:
        assert getattr(PK, name) is not None
    for name in ("ops", "ref"):
        assert getattr(PK, name).__name__ == f"repro_torch.kernels.{name}"


# ---------------------------------------------------------------------------
# gather_join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 513, 4096])
@pytest.mark.parametrize("k,c", [(5, 1), (25, 4), (640, 3)])
def test_gather_join_matches_pallas(n, k, c):
    rng = np.random.default_rng(n + k + c)
    fk = rng.integers(0, k, n).astype(np.int32)
    table = rng.normal(size=(k, c)).astype(np.float32)
    got = PK.gather_join(T(fk), T(table))
    assert got.shape == (n, c) and got.dtype == torch.float32
    _eq(got, RK.gather_join(jnp.asarray(fk), jnp.asarray(table), tile=512,
                            interpret=True))
    _eq(got, RK.ref.gather_join_ref(jnp.asarray(fk), jnp.asarray(table)))


@pytest.mark.parametrize("n", [1, 37, 513])
def test_gather_join_out_of_range_keys_give_zeros(n):
    k, c = 25, 3
    rng = np.random.default_rng(n)
    fk = rng.integers(-3, k + 3, n).astype(np.int32)
    fk[0] = -1 if n > 1 else k
    fk[-1] = k
    table = rng.normal(size=(k, c)).astype(np.float32)
    got = PK.gather_join(T(fk), T(table))
    _eq(got, RK.gather_join(jnp.asarray(fk), jnp.asarray(table), tile=512,
                            interpret=True))
    bad = (fk < 0) | (fk >= k)
    assert not got.numpy()[bad].any()


def test_gather_join_nonfinite_table_follows_the_oracle():
    """The reference's one-hot product spreads a NaN or infinity of the
    table into every row (0 * inf); the port gathers exactly, as the
    reference's oracle does."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    table[1, 2] = np.nan
    table[3, 0] = np.inf
    fk = np.array([0, 1, 2, 3, 4, -1, 2], np.int32)
    got = PK.gather_join(T(fk), T(table))
    _eq(got, RK.ref.gather_join_ref(jnp.asarray(fk), jnp.asarray(table)))
    assert np.isfinite(got.numpy()[[0, 2, 4, 5, 6]]).all()


# ---------------------------------------------------------------------------
# masked_topk
# ---------------------------------------------------------------------------

def _topk_both(vals, mask, k, pallas=True):
    got = PK.masked_topk(T(vals), T(mask), k)
    want = RK.ref.masked_topk_ref(jnp.asarray(vals), jnp.asarray(mask), k)
    for g, w in zip(got, want):
        _eq(g, w)
    if pallas:
        kern = RK.masked_topk(jnp.asarray(vals), jnp.asarray(mask), k,
                              tile=2048, interpret=True)
        for g, w in zip(got, kern):
            _eq(g, w)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[0].shape == got[1].shape == (k,)
    return got


def _distinct(n, k):
    rng = np.random.default_rng(n + k)
    return rng.permutation(n).astype(np.float32), rng.random(n) < 0.7


@pytest.mark.parametrize("n", [10, 1000, 9001])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_masked_topk_matches_oracle(n, k):
    _topk_both(*_distinct(n, k), k, pallas=False)


@pytest.mark.parametrize("n,k", [(10, 1), (1000, 10), (9001, 32)])
def test_masked_topk_matches_pallas(n, k):
    _topk_both(*_distinct(n, k), k)


@pytest.mark.parametrize("n,k,pallas", [(9001, 10, False), (9001, 32, False),
                                        (4100, 32, True)])
def test_masked_topk_ties_go_to_the_lower_row(n, k, pallas):
    """Eight distinct values over thousands of rows: equal values across
    Pallas tiles (2048 rows) keep the lower row first."""
    rng = np.random.default_rng(n * k)
    vals = rng.choice(np.float32([-1.5, 0, 0.25, 2, 3, 7.5, 9, 11]), n)
    mask = rng.random(n) < 0.5
    _, ids = _topk_both(vals, mask, k, pallas)
    top = vals[ids.numpy()]
    assert (top == top[0]).all()          # every one a tie of the maximum
    assert (np.diff(ids.numpy()) > 0).all()


@pytest.mark.parametrize("case", ["few_valid", "none_valid", "k_above_n"])
def test_masked_topk_pads_with_sentinel(case):
    rng = np.random.default_rng(5)
    n, k = {"few_valid": (100, 32), "none_valid": (50, 10),
            "k_above_n": (10, 32)}[case]
    vals = rng.normal(size=n).astype(np.float32)
    mask = {"few_valid": rng.permutation(n) < 5,
            "none_valid": np.zeros(n, bool),
            "k_above_n": rng.random(n) < 0.6}[case]
    v, i = _topk_both(vals, mask, k, pallas=case == "k_above_n")
    valid = int(mask.sum())
    assert (i.numpy()[valid:] == -1).all()
    assert (v.numpy()[valid:] == np.float32(-3.0e38)).all()


def test_masked_topk_values_at_or_below_the_sentinel_get_no_row():
    """A valid -inf (or any value <= -3e38) keeps its value and gets id
    -1, and sorts after the masked rows, as in the reference's oracle."""
    vals = np.float32([2.0, -np.inf, 5.0, -3.0e38, 1.0])
    mask = np.array([True, True, False, True, True])
    v, i = _topk_both(vals, mask, 5, pallas=False)
    np.testing.assert_array_equal(
        v.numpy(), np.float32([2.0, 1.0, -3.0e38, -3.0e38, -np.inf]))
    np.testing.assert_array_equal(i.numpy(), [0, 4, -1, -1, -1])


@pytest.mark.parametrize("k", [0, MAX_K + 1])
def test_masked_topk_rejects_unsupported_k(k):
    with pytest.raises(ValueError, match="1024"):
        PK.masked_topk(torch.ones(4), torch.ones(4, dtype=torch.bool), k)


# -- IEEE total order: NaN, signed zeros, subnormals, infinities ----------

# float32 bit patterns: +-0, +-NaN (with payloads, quiet and signalling),
# +-inf, +-subnormals, -3e38 and its two neighbours
SPECIAL_BITS = np.array(
    [0x00000000, 0x80000000, 0x7fc00000, 0xffc00000, 0x7fc00001, 0xffc00005,
     0x7f800001, 0xff800001, 0x7f800000, 0xff800000, 0x00000001, 0x80000001,
     0x007fffff, 0x807fffff, 0xff61b1e6, 0xff61b1e5, 0xff61b1e7],
    np.uint32)


def _topk_bitwise(vals, mask, k):
    """The port's top-k against the oracle: ids exactly, values bit for
    bit (NaN payloads included)."""
    got = PK.masked_topk(T(vals), T(mask), k)
    want = RK.ref.masked_topk_ref(jnp.asarray(vals), jnp.asarray(mask), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32))
    return got


@pytest.mark.parametrize("k", [1, 3, 8, 12])
@pytest.mark.parametrize("mask", ["all", "alternate", "none"])
def test_masked_topk_signed_zero_and_nan_order(k, mask):
    """[-0, 0, -0, 1, nan, 0, -nan, inf]: the oracle's ids are
    [4, 7, 3, 1, 5, 0, 2, 6] (+NaN first, +0 before -0, -NaN last and
    kept); k = 12 pads past n = 8, and the padding (-3e38) comes before
    -NaN."""
    vals = np.float32([-0.0, 0.0, -0.0, 1.0, np.nan, 0.0, -np.nan, np.inf])
    m = {"all": np.ones(8, bool), "alternate": np.arange(8) % 2 == 0,
         "none": np.zeros(8, bool)}[mask]
    _, ids = _topk_bitwise(vals, m, k)
    if mask == "all":
        want = [4, 7, 3, 1, 5, 0, 2, 6] if k <= 8 else \
            [4, 7, 3, 1, 5, 0, 2, -1, -1, -1, -1, 6]
        np.testing.assert_array_equal(ids.numpy(), want[:k])


@pytest.mark.parametrize("n,k", [(5000, 1), (5000, 10), (5000, 1024),
                                 (300, 1024), (9001, 100)])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_masked_topk_special_values_match_oracle(n, k, density):
    """Special bit patterns scattered among repeated ordinary values, so
    every special value has ties across many rows."""
    rng = np.random.default_rng(n + k + int(10 * density))
    vals = rng.choice(np.float32([-2.5, 0.5, 1.0, 3e38, -1.0]), n)
    at = rng.random(n) < 0.35
    vals[at] = rng.choice(SPECIAL_BITS, int(at.sum())).view(np.float32)
    _topk_bitwise(vals, rng.random(n) < density, k)


# -- the radix select's key and digit walk, compiled as host C++ ---------

_SHIM = r"""
#include "radix_select.cuh"
extern "C" {
void keys_of(const unsigned* bits, long long n, unsigned* out) {
  for (long long i = 0; i < n; ++i) out[i] = repro::order_key(bits[i]);
}
void bits_of(const unsigned* keys, long long n, unsigned* out) {
  for (long long i = 0; i < n; ++i) out[i] = repro::key_bits(keys[i]);
}
int pass_bins(int pass) { return 1 << repro::radix_bits(pass); }
// the pass's digit of each key, -1 where the key leaves the prefix
void digits_of(const unsigned* keys, long long n, unsigned prefix, int pass,
               int* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = repro::radix_match(keys[i], prefix, pass)
                 ? (int)repro::radix_digit(keys[i], pass) : -1;
}
// topk.cu's pick, lane by lane: 32 chunks of bins from the top, the
// chunk where the rank falls, then walk_down inside it
void select_step(const unsigned* hist, int pass, unsigned* state) {
  const int bins = 1 << repro::radix_bits(pass), per = bins / 32;
  repro::RadixState s{state[0], state[1], state[2]};
  unsigned excl = 0;
  for (int lane = 0; lane < 32; ++lane) {
    const int lo = bins - per * (lane + 1);
    unsigned c = 0;
    for (int d = 0; d < per; ++d) c += hist[lo + d];
    if (excl < s.rank && s.rank <= excl + c) {
      unsigned before;
      const int d = repro::walk_down(hist + lo, per, s.rank - excl, &before);
      repro::radix_advance(&s, pass, (unsigned)(lo + d), excl + before);
      break;
    }
    excl += c;
  }
  state[0] = s.prefix; state[1] = s.rank; state[2] = s.above;
}
}
"""


@pytest.fixture(scope="module")
def radix_shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to build radix_select.cuh")
    d = tmp_path_factory.mktemp("radix")
    (d / "shim.cpp").write_text(_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(d / "shim.so"), str(d / "shim.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.keys_of.argtypes = lib.bits_of.argtypes = [vp, ll, vp]
    lib.digits_of.argtypes = [vp, ll, ctypes.c_uint, i, vp]
    lib.select_step.argtypes = [vp, i, vp]
    return lib


def _call(fn, a, out_dtype, *extra):
    a = np.ascontiguousarray(a)
    out = np.empty(a.shape[0], out_dtype)
    fn(a.ctypes.data, a.shape[0], *extra, out.ctypes.data)
    return out


def test_order_key_orders_special_values_as_top_k(radix_shim):
    """Sorting by the header's key, descending (ties to the lower row),
    gives `jax.lax.top_k`'s order of the special values, and key_bits
    inverts the key."""
    bits = np.concatenate([SPECIAL_BITS, SPECIAL_BITS[::-1],
                           np.float32([1.5, -1.5, 3e38]).view(np.uint32)])
    keys = _call(radix_shim.keys_of, bits, np.uint32)
    order = np.argsort(-keys.astype(np.int64), kind="stable")
    _, want = jax.lax.top_k(jnp.asarray(bits.view(np.float32)), len(bits))
    np.testing.assert_array_equal(order, np.asarray(want))
    np.testing.assert_array_equal(_call(radix_shim.bits_of, keys, np.uint32),
                                  bits)


@pytest.mark.parametrize("case", ["random", "all_equal", "all_masked",
                                  "special"])
@pytest.mark.parametrize("k", [1, 10, 1024])
def test_radix_walk_finds_the_kth_key(radix_shim, case, k):
    """Three passes over numpy histograms of the header's digits, each
    followed by the header's walk, find the k-th largest key T and the
    count of keys above it, as a sort does."""
    rng = np.random.default_rng(k)
    n = 20_000
    vals = {"random": rng.normal(size=n).astype(np.float32),
            "all_equal": np.full(n, 2.5, np.float32),
            "all_masked": np.full(n, -3e38, np.float32),
            "special": rng.choice(SPECIAL_BITS, n).view(np.float32)}[case]
    keys = _call(radix_shim.keys_of, vals.view(np.uint32), np.uint32)
    state = np.array([0, k, 0], np.uint32)
    for p in range(3):
        digits = _call(radix_shim.digits_of, keys, np.int32,
                       ctypes.c_uint(int(state[0])), p)
        bins = radix_shim.pass_bins(p)
        hist = np.bincount(digits[digits >= 0], minlength=bins
                           ).astype(np.uint32)
        radix_shim.select_step(hist.ctypes.data, p, state.ctypes.data)
    t = np.sort(keys)[::-1][k - 1]
    assert state[0] == t
    assert state[2] == (keys > t).sum()
    assert state[1] == k - state[2] and (keys == t).sum() >= state[1]


# ---------------------------------------------------------------------------
# filter_agg (matrix form) and compact_translate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,G,A", [(1, 1, 1), (37, 6, 3), (5000, 130, 2),
                                   (5000, 6, 5)])
def test_filter_agg_matrix_matches_pallas(n, G, A):
    rng = np.random.default_rng(n + G + A)
    mask = rng.random(n) < 0.6
    gidx = rng.integers(-1, G + 1, n).astype(np.int32)   # some out of range
    vals = rng.normal(size=(n, A)).astype(np.float32)
    got = PK.filter_agg(T(mask), T(gidx), T(vals), G)
    assert got.shape == (G, A)
    want = RK.filter_agg(jnp.asarray(mask), jnp.asarray(gidx),
                         jnp.asarray(vals), G, tile=1024, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        PK.ref.filter_agg_ref(T(mask), T(gidx), T(vals), G).numpy(),
        np.asarray(RK.ref.filter_agg_ref(jnp.asarray(mask),
                                         jnp.asarray(gidx),
                                         jnp.asarray(vals), G)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,cap", [(37, 16), (5000, 256)])
def test_compact_translate_matches_pallas(n, cap):
    rng = np.random.default_rng(n * 3 + cap)
    mask = rng.random(n) < 0.3
    got = PK.compact_translate(T(mask), cap)
    want = RK.compact_translate(jnp.asarray(mask), cap, tile=512,
                                interpret=True)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(PK.ref.slot_of_ref(T(mask)), RK.ref.slot_of_ref(jnp.asarray(mask)))
    for g, w in zip(PK.ref.compact_ref(T(mask), cap),
                    RK.ref.compact_ref(jnp.asarray(mask), cap)):
        _eq(g, w)


# ---------------------------------------------------------------------------
# selective_filter_agg with a compaction capacity
# ---------------------------------------------------------------------------

def _selective_operands(pred, n, grouped):
    cols_np = _columns(n, seed=5 * n + len(pred))
    pe, re_ = _preds(PE)[pred], _preds(RE)[pred]
    pv, rv = _values(PE), _values(RE)
    radix = [("c0", 7, 3), ("k0", 3, 1)] if grouped else []
    G = 21 if grouped else 1
    names = set(PE.expr_columns(pe)) | {g for g, _, _ in radix}
    for e in pv:
        names |= PE.expr_columns(e)
    pnames = []
    for e in [pe] + pv:
        pnames += [p for p in _pnames(e) if p not in pnames]
    jcols, jsc, tcols, tsc = _operands(cols_np, sorted(names), pnames)
    port = (tcols, tsc, fu.TileFn(pe, pnames),
            [fu.TileFn(e, pnames) for e in pv],
            fu.GroupIndex(radix, G) if grouped else None, len(pv), G)

    def jgidx(cols, _s):
        idx = cols["c0"].astype(jnp.int32) * 3 + cols["k0"].astype(jnp.int32)
        return jnp.clip(idx, 0, G - 1)

    rvals = [ref_fused.make_tile_fn(e, pnames) for e in rv]
    ref = (jcols, jsc, ref_fused.make_tile_fn(re_, pnames),
           lambda c, s: [f(c, s) for f in rvals],
           jgidx if grouped else None, len(rv), G)
    return port, ref


def _same_selective(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)


@pytest.mark.parametrize("pred,grouped,n", [("q6like", False, 1),
                                            ("q6like", False, 37),
                                            ("q6like", False, 5000),
                                            ("params", True, 5000)])
@pytest.mark.parametrize("capacity,translate", [(8, False), (8, True),
                                                (512, False), (512, True)])
def test_selective_capacity_matches_oracle(pred, grouped, n, capacity,
                                           translate):
    port, ref = _selective_operands(pred, n, grouped)
    got = PK.selective_filter_agg(*port, capacity=capacity,
                                  translate=translate)
    _same_selective(got, RK.ref.selective_filter_agg_ref(
        *ref, capacity=capacity, translate=translate))
    _same_selective(PK.ref.selective_filter_agg_ref(*port, capacity,
                                                    translate), got)
    # the aggregation does not change with the compaction outputs
    plain = PK.selective_filter_agg(*port)
    assert len(plain) == 2 and int(plain[1]) == int(got[1])
    assert torch.equal(plain[0], got[0])


@pytest.mark.parametrize("pred,grouped,n", [("q6like", False, 1),
                                            ("q6like", False, 37),
                                            ("q6like", False, 5000),
                                            ("params", True, 5000)])
@pytest.mark.parametrize("capacity", [8, 512])
def test_selective_capacity_matches_pallas(pred, grouped, n, capacity):
    port, ref = _selective_operands(pred, n, grouped)
    got = PK.selective_filter_agg(*port, capacity=capacity, translate=True)
    _same_selective(got, RK.selective_filter_agg(
        *ref, capacity=capacity, translate=True, interpret=True))


def test_selective_translate_needs_a_capacity():
    port, _ = _selective_operands("q6like", 37, False)
    with pytest.raises(ValueError, match="capacity"):
        PK.selective_filter_agg(*port, capacity=0, translate=True)
    with pytest.raises(ValueError, match="n_vals"):
        PK.selective_filter_agg(*port[:5], 7, port[6])


# ---------------------------------------------------------------------------
# float rules the CUDA build must keep
# ---------------------------------------------------------------------------

def test_subnormal_literal_survives_codegen_and_build_flags():
    """A subnormal float32 literal is emitted as itself, and no flag of
    the build flushes subnormals to zero (the reference's XLA on the CPU
    does: see ROADMAP Queue 3)."""
    x = np.float32(1.1754944e-39)
    assert 0 < x < np.finfo(np.float32).tiny
    lit = codegen.float_literal(x)
    assert lit.endswith("f") and np.float32(lit[:-1]) == x
    flags = " ".join(build.NVCC_FLAGS)
    for bad in ("fast-math", "fast_math", "ftz=true", "ftz"):
        assert bad not in flags
