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
import importlib
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

# by full name: the package exports a function named filter_agg
kfa = importlib.import_module("repro_torch.kernels.filter_agg")


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


# The non-finite case: a NaN in a row the mask drops (row 4) and an
# infinity in a kept row of group 1 (row 2).  The oracle's `where` keeps
# each out of every other group's sum; the reference's Pallas kernel
# multiplies by its one-hot matrix (0 * NaN, 0 * inf) and spreads them.
NF_MASK = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
NF_GIDX = np.array([0, 1, 1, 0, 0, 2, 2, 1], np.int32)
NF_SUMS = np.array([[6, 8], [np.inf, 20], [22, 24]], np.float32)
NF_COUNTS = np.array([2, 2, 2], np.int32)


def nonfinite_vals():
    vals = np.arange(16, dtype=np.float32).reshape(8, 2)
    vals[4, 1] = np.nan
    vals[2, 0] = np.inf
    return vals


def _same_bits(got, want):
    np.testing.assert_array_equal(
        np.asarray(got, np.float32).view(np.int32),
        np.asarray(want, np.float32).view(np.int32))


def test_filter_agg_nonfinite_follows_the_oracle():
    vals = nonfinite_vals()
    jm, jg, jv = (jnp.asarray(a) for a in (NF_MASK, NF_GIDX, vals))
    _same_bits(RK.ref.filter_agg_ref(jm, jg, jv, 3), NF_SUMS)
    cols = [T(np.ascontiguousarray(c)) for c in vals.T]
    sums, counts = kfa.filter_agg_plain(T(NF_MASK), T(NF_GIDX), cols, 3)
    _same_bits(sums, NF_SUMS)
    _eq(counts, NF_COUNTS)
    sums, counts = PK.ops.filter_agg_query(T(NF_MASK), T(NF_GIDX), cols, 3)
    _same_bits(sums, NF_SUMS)
    _eq(counts, NF_COUNTS)
    _same_bits(PK.filter_agg(T(NF_MASK), T(NF_GIDX), T(vals), 3), NF_SUMS)
    _same_bits(PK.ref.filter_agg_ref(T(NF_MASK), T(NF_GIDX), T(vals), 3),
               NF_SUMS)
    # the reference's Pallas kernel: NaN everywhere but group 1's infinity
    pallas = np.asarray(RK.filter_agg(jm, jg, jv, 3, tile=8, interpret=True))
    assert np.isnan(pallas[[0, 2]]).all() and np.isnan(pallas[1, 1])
    assert pallas[1, 0] == np.inf


def test_selective_filter_agg_nonfinite_follows_the_oracle():
    """The same rows through the selective form, whose predicate drops
    the NaN row."""
    vals = nonfinite_vals()
    np_cols = {"g": NF_GIDX, "m": NF_MASK.astype(np.int32),
               "v0": np.ascontiguousarray(vals[:, 0]),
               "v1": np.ascontiguousarray(vals[:, 1])}
    pred = lambda E: E.Cmp("==", E.Col("m"), E.Const(1))   # noqa: E731
    tcols = {k: T(v) for k, v in np_cols.items()}
    vfns = [fu.TileFn(PE.Col(c), []) for c in ("v0", "v1")]
    gfn = fu.GroupIndex([("g", 3, 1)], 3)
    sums, counts, total = kfa.selective_filter_agg_plain(
        tcols, [], fu.TileFn(pred(PE), []), vfns, gfn, 3)
    _same_bits(sums, NF_SUMS)
    _eq(counts, NF_COUNTS)
    assert int(total) == 6
    got = PK.selective_filter_agg(tcols, [], fu.TileFn(pred(PE), []), vfns,
                                  gfn, 2, 3)
    _same_bits(got[0], NF_SUMS)
    rvals = [ref_fused.make_tile_fn(RE.Col(c), []) for c in ("v0", "v1")]
    want = RK.ref.selective_filter_agg_ref(
        {k: jnp.asarray(v) for k, v in np_cols.items()}, [],
        ref_fused.make_tile_fn(pred(RE), []),
        lambda c, s: [f(c, s) for f in rvals], lambda c, _s: c["g"], 2, 3)
    _same_bits(want[0], NF_SUMS)
    assert int(want[1]) == int(got[1]) == 6


_AGG_SHIM = r"""
#include "agg_regs.cuh"
extern "C" {
int regime(int G, int A) { return repro::register_regime(G, A) ? 1 : 0; }
// rows through one thread's accumulators of the static library's
// G <= 8, A <= 8 instance, in row order
void reg_agg(const unsigned char* m, const int* g, const float* v,
             long long n, int G, int A, float* sums, int* counts,
             int* kept) {
  repro::RegAcc<8, 8> acc;
  acc.zero();
  for (long long i = 0; i < n; ++i) {
    float row[8] = {0.f};
    for (int k = 0; k < A; ++k) row[k] = v[i * A + k];
    acc.add(m[i] != 0, g[i], G, row);
  }
  for (int j = 0; j < G; ++j) {
    counts[j] = acc.cnt[j];
    for (int k = 0; k < A; ++k) sums[j * A + k] = acc.sum[j][k];
  }
  *kept = acc.kept;
}
int fold_lanes(int outputs) { return repro::fold_lanes(outputs); }
// the register regime's fold of `rows` partial rows of `stride` words
// (`outputs` of them, the first GA float sums), in the kernel's order of
// additions
void fold(const int* ws, long long stride, int rows, int outputs, int GA,
          int* out) {
  repro::fold_serial(ws, stride, rows, outputs, GA, out);
}
}
"""


@pytest.fixture(scope="module")
def agg_shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to build agg_regs.cuh")
    d = tmp_path_factory.mktemp("agg")
    (d / "shim.cpp").write_text(_AGG_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(d / "shim.so"), str(d / "shim.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.regime.argtypes = [i, i]
    lib.reg_agg.argtypes = [vp, vp, vp, ll, i, i, vp, vp, vp]
    lib.fold_lanes.argtypes = [i]
    lib.fold.argtypes = [vp, ll, i, i, i, vp]
    return lib


def _reg_agg(lib, mask, gidx, vals, G):
    n, A = vals.shape
    m, g = np.ascontiguousarray(mask, np.uint8), np.ascontiguousarray(gidx)
    v = np.ascontiguousarray(vals)
    sums, counts = np.zeros((G, A), np.float32), np.zeros(G, np.int32)
    kept = np.zeros(1, np.int32)
    lib.reg_agg(m.ctypes.data, g.ctypes.data, v.ctypes.data, n, G, A,
                sums.ctypes.data, counts.ctypes.data, kept.ctypes.data)
    return sums, counts, int(kept[0])


def test_register_step_keeps_nonfinite_values_in_their_group(agg_shim):
    """The register regime's per-row step (compiled from the kernel's own
    header) gives the oracle's sums bit for bit on the non-finite case,
    and agrees with the plain version on random rows with groups out of
    range."""
    sums, counts, kept = _reg_agg(agg_shim, NF_MASK, NF_GIDX,
                                  nonfinite_vals(), 3)
    _same_bits(sums, NF_SUMS)
    _eq(T(counts), NF_COUNTS)
    assert kept == 6
    rng = np.random.default_rng(7)
    n, G, A = 3001, 8, 8
    mask = rng.random(n) < 0.6
    gidx = rng.integers(-1, G + 1, n).astype(np.int32)
    vals = rng.normal(size=(n, A)).astype(np.float32)
    sums, counts, kept = _reg_agg(agg_shim, mask, gidx, vals, G)
    want, wcounts = kfa.filter_agg_plain(T(mask), T(gidx),
                                         [T(np.ascontiguousarray(c))
                                          for c in vals.T], G)
    np.testing.assert_allclose(sums, want.numpy(), rtol=RTOL, atol=ATOL)
    _eq(T(counts), wcounts.numpy())
    assert kept == int(mask.sum())


@pytest.mark.parametrize("G,A,regs", [
    (6, 7, True), (7, 2, True), (1, 1, True),       # q1, q12, q6
    (8, 8, True), (9, 8, False), (8, 9, False), (1, 16, True),
    (1, 17, False), (2, 16, False), (4096, 2, False), (1, 0, True)])
def test_register_regime_boundary(agg_shim, G, A, regs):
    """Which (G, A) the kernels aggregate in registers (bit-identical
    sums): every shape of the engine's main path does."""
    assert agg_shim.regime(G, A) == int(regs)


def _fold_in_order(parts, o, lanes):
    """Output o of the fold as its order is documented: lane r adds rows
    r, r + W, ... in row order, then the lanes by a tree (r += r + W/2,
    then r + W/4, ...), every addition in the output's own type."""
    add = (lambda a, b: np.float32(a + b)) if parts.dtype == np.float32 \
        else (lambda a, b: np.int32(a + b))
    zero = parts.dtype.type(0)
    acc = []
    for r in range(lanes):
        a = zero
        for b in range(r, parts.shape[0], lanes):
            a = add(a, parts[b, o])
        acc.append(a)
    h = lanes // 2
    while h:
        for r in range(h):
            acc[r] = add(acc[r], acc[r + h])
        h //= 2
    return acc[0]


@pytest.mark.parametrize("rows,G,A", [
    (887, 1, 1), (264, 6, 7), (256, 7, 2),     # q6, q1, q12 on a full card
    (1, 1, 0), (37, 8, 8), (1024, 1, 16)])
def test_register_fold_order_is_fixed(agg_shim, rows, G, A):
    """The register regime's in-kernel fold adds the partials in its
    documented fixed order (float sums bit for bit, counts exact) and
    gives the same bits on a second call: the order depends on (rows,
    outputs) alone, never on which block came last.  It runs on the host
    through the kernel's own `fold_lane` and `fold_tree`, the two steps
    `fold_rows` calls; only the mapping of lanes to threads and the
    barriers are the kernel's alone."""
    ga, outputs = G * A, G * A + G + 1
    stride = (outputs + 3) // 4 * 4
    lanes = agg_shim.fold_lanes(outputs)
    assert lanes == 256 // (1 << ((outputs + 3) // 4 - 1).bit_length())
    rng = np.random.default_rng(rows * 100 + outputs)
    sums = (rng.normal(size=(rows, ga))
            * 10.0 ** rng.integers(-3, 7, (rows, ga))).astype(np.float32)
    counts = rng.integers(0, 1 << 20, (rows, outputs - ga)).astype(np.int32)
    ws = np.zeros((rows, stride), np.int32)
    ws[:, :ga] = sums.view(np.int32)
    ws[:, ga:outputs] = counts
    first, again = np.zeros(outputs, np.int32), np.zeros(outputs, np.int32)
    for out in (first, again):
        agg_shim.fold(ws.ctypes.data, stride, rows, outputs, ga,
                      out.ctypes.data)
    np.testing.assert_array_equal(first, again)
    want_sums = [_fold_in_order(sums, o, lanes) for o in range(ga)]
    _same_bits(first[:ga].view(np.float32), want_sums)
    np.testing.assert_array_equal(
        first[ga:], [_fold_in_order(counts, o, lanes)
                     for o in range(outputs - ga)])
    np.testing.assert_array_equal(first[ga:], counts.sum(0))


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


# ---------------------------------------------------------------------------
# launches per call: value chunks, the one-pass compact_pred, library keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,A", [(3, 17), (4096, 14), (1, 16), (8, 0),
                                 (4096, 1)])
def test_value_chunks_fit_every_launch(G, A):
    """The CUDA wrappers cut A value columns into launches that each take
    at most the static library's 16 columns and fit G x (a + 1) words in
    one block's shared memory; the chunks cover A in order, and for
    G <= 4096 each but the last holds at least 13 columns."""
    chunks = kfa.value_chunks(G, A)
    assert chunks[0][0] == 0 and chunks[-1][1] == A
    for (a0, a1), (b0, _b1) in zip(chunks, chunks[1:]):
        assert a1 == b0
    for start, stop in chunks:
        a = stop - start
        assert a <= kfa.MAX_VALS == 16
        assert G * (a + 1) * 4 <= kfa.SMEM_LIMIT
    assert all(stop - start >= min(13, A) for start, stop in chunks[:-1])
    assert all(stop > start for start, stop in chunks) or chunks == [(0, 0)]
    assert 'kMaxVals = 16' in (CSRC / "filter_agg.cu").read_text()


def test_value_chunks_raise_where_no_column_fits():
    G = kfa.SMEM_LIMIT // 8 + 1           # G x 2 x 4 B > SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kfa.value_chunks(G, 1)
    assert kfa.value_chunks(G - 1, 1) == [(0, 1)]


@pytest.mark.parametrize("G,A,nb", [(1, 1, 264), (8, 8, 1024),
                                    (4096, 13, 1024)])
def test_aggregation_result_keeps_only_small_partials(monkeypatch, G, A, nb):
    """The aggregation's result is one row of the partials' layout: in the
    partials' own allocation, right after them, while they are small
    (every register-regime shape), and an allocation of its own beside
    large partials, so that a result the engine keeps never holds them
    alive.  The kernel's `out` pointer is the result's first word."""
    monkeypatch.setattr(kfa, "_agg_blocks", lambda n, g, a: nb)
    got_nb, ws, out, (sums, counts, total) = kfa._outputs(
        10, G, A, torch.device("cpu"))
    row = (G * A + G + 1 + 3) // 4 * 4
    shared = nb * row <= kfa.SHARED_ALLOC_WORDS
    assert shared == (G * A <= 64)
    assert got_nb == nb
    assert ws.numel() == nb * row + (row if shared else 0)
    same = sums.untyped_storage().data_ptr() == ws.untyped_storage().data_ptr()
    assert same == shared
    assert out % 16 == 0
    assert out == (ws.data_ptr() + 4 * nb * row if shared
                   else sums.untyped_storage().data_ptr())
    assert sums.shape == (G, A) and sums.dtype == torch.float32
    assert counts.shape == (G,) and total.shape == ()
    assert sums.data_ptr() == out
    assert counts.data_ptr() == out + 4 * G * A
    assert total.data_ptr() == out + 4 * (G * A + G)


def test_compact_pred_source_is_one_pass():
    """The generated compact_pred instantiates the look-back scan on the
    predicate's own functor (one memset, one launch): no byte pass, and
    the workspace holds no byte mask."""
    pe = _preds(PE)["q6like"]
    names = sorted(PE.expr_columns(pe))
    em = codegen.Emitter({c: "float" if c.startswith("f") else "int"
                          for c in names}, {})
    src = codegen.compact_pred_source(pe, em)
    assert "repro::compact_into(s, n, ws" in src
    assert "bytes" not in src and "MaskSource" not in src
    # every column is loaded before the predicate reads it
    body = src[src.index("bool pred("):src.index("int group(")]
    assert body.index("= c0[i];") < body.index("return")
    header = (CSRC / "compact.cuh").read_text()
    assert "predicate_bytes" not in header and "bytes)" not in header
    kc = importlib.import_module("repro_torch.kernels.compact")
    for n, cap, tr in [(0, 1, False), (5000, 64, False), (5000, 64, True),
                       (1 << 20, 3, True)]:
        ws, out = kc._workspace(n, cap, tr, torch.device("cpu"))
        assert ws.shape[0] == kc.workspace_head(n) + cap + (n if tr else 0)
        assert out[0].shape == (cap,) and out[1].ndim == 0


class _FakeLib:
    """A loaded library's stand-in: the wrappers set argtypes on it."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def count_generation(monkeypatch):
    """Count source generations behind the generated libraries' caches,
    with `build.load` stubbed (no nvcc here)."""
    kc = importlib.import_module("repro_torch.kernels.compact")
    counts = {"compact_pred": 0, "selective_agg": 0}
    for name in counts:
        real = getattr(codegen, f"{name}_source")

        def counted(*a, _name=name, _real=real, **k):
            counts[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(codegen, f"{name}_source", counted)
    monkeypatch.setattr(build, "load", lambda name, src: _FakeLib())
    monkeypatch.setattr(kc, "_PRED_LIBS", {})
    monkeypatch.setattr(kfa, "_GEN_LIBS", {})
    return kc, counts


def _key_operands(int_dtype=torch.int32, scalar=40, grouped=True):
    cols = {"c0": torch.zeros(8, dtype=torch.int32),
            "f0": torch.zeros(8), "i0": torch.zeros(8, dtype=int_dtype),
            "k0": torch.zeros(8, dtype=torch.int32)}
    pred = PE.And(PE.Cmp("<", PE.Col("i0"), PE.Param("pi", "int32")),
                  PE.Cmp(">=", PE.Col("f0"), PE.Const(0.05)))
    vals = [fu.TileFn(PE.Col("f0"), ["pi"]),
            fu.TileFn(PE.Arith("*", PE.Col("f0"), PE.Const(2)), ["pi"])]
    gfn = fu.GroupIndex([("c0", 7, 3), ("k0", 3, 1)], 21) if grouped \
        else None
    return cols, [scalar], fu.TileFn(pred, ["pi"]), vals, gfn


def test_generated_library_key_skips_generation_on_a_hit(count_generation):
    """An equal Expr tree (another object) with another parameter value
    finds the library built for the first: one source generation for
    each generated kernel."""
    kc, counts = count_generation
    for scalar in (40, 7, 40):
        cols, sc, pred, vals, gfn = _key_operands(scalar=scalar)
        kc._pred_lib(cols, sc, pred)
        kfa._selective_lib(cols, sc, pred, vals, gfn, 21)
    assert counts == {"compact_pred": 1, "selective_agg": 1}
    assert len(kc._PRED_LIBS) == len(kfa._GEN_LIBS) == 1


def test_generated_library_key_separates_different_sources():
    """Every difference that changes the generated source changes the
    key: a column dtype, a parameter kind, the value list, G, a constant
    of another type or sign."""
    kc = importlib.import_module("repro_torch.kernels.compact")
    cols, sc, pred, vals, gfn = _key_operands()

    def keys(cols=cols, sc=sc, pred=pred, vals=vals, gfn=gfn, G=21):
        return (kc.pred_key(cols, sc, pred),
                kfa.selective_key(cols, sc, pred, vals, gfn, G))

    base = keys()
    assert keys(sc=[7]) == base
    wide = dict(cols, i0=torch.zeros(8))
    narrow = dict(cols, i0=torch.zeros(8, dtype=torch.bool))
    other_const = fu.TileFn(PE.And(pred.expr.lhs, PE.Cmp(
        ">=", PE.Col("f0"), PE.Const(0))), ["pi"])
    neg_zero = (fu.TileFn(PE.Cmp(">=", PE.Col("f0"), PE.Const(0.0)), []),
                fu.TileFn(PE.Cmp(">=", PE.Col("f0"), PE.Const(-0.0)), []))
    variants = [keys(cols=wide), keys(cols=narrow), keys(sc=[7.5]),
                keys(sc=[True]), keys(pred=other_const),
                keys(vals=vals[:1]), keys(vals=vals[::-1]),
                keys(gfn=fu.GroupIndex([("c0", 7, 3), ("k0", 3, 1)], 22),
                     G=22),
                keys(gfn=None, G=1)]
    for v in variants:
        assert v[1] != base[1]
    for v in variants[:5]:
        assert v[0] != base[0]
    a, b = (kc.pred_key(cols, [], f) for f in neg_zero)
    assert a != b
    assert neg_zero[0].expr == neg_zero[1].expr     # equal as trees
    assert codegen.expr_key(PE.Const(1)) != codegen.expr_key(PE.Const(1.0))
    # what the key separates, the source separates too
    em = codegen.Emitter(codegen.column_types(cols), {"pi": "int"})
    assert (codegen.compact_pred_source(neg_zero[0].expr, em)
            != codegen.compact_pred_source(neg_zero[1].expr, em))
