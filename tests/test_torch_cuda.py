"""The CUDA kernels against their plain torch versions, on the card.

Run on a machine with an NVIDIA Hopper card and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without CUDA every test here skips (the decision is taken inside the
`cuda` fixture, never at import).  Integer outputs must match exactly;
float sums within rtol 1e-3, atol 1e-3 (the kernels and `index_add_` add
in different orders).
"""
import importlib

import numpy as np
import pytest
import torch

import repro_torch.kernels as lib
from repro_torch.core import CompiledQuery, preset
from repro_torch.core.expr import And, Cmp, Col, CodeIn, Const, Param
from repro_torch.core.operators import fused as fu
from repro_torch.relational import Database
from repro_torch.relational.queries import QUERIES
from test_queries import SORT_INSENSITIVE, assert_same

pytestmark = pytest.mark.cuda

# by full name: the package exports functions named compact, filter_agg
# and gather_join
kc = importlib.import_module("repro_torch.kernels.compact")
kf = importlib.import_module("repro_torch.kernels.filter_agg")
kg = importlib.import_module("repro_torch.kernels.gather_join")
kt = importlib.import_module("repro_torch.kernels.topk")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 37, 5000, 1 << 20])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("translate", [False, True])
def test_compact_kernel(cuda, n, p, translate):
    rng = np.random.default_rng(n + int(10 * p))
    mask = torch.from_numpy(rng.random(n) < p).to(cuda)
    before = kc.launches["compact"]
    for cap in (1, 64, n // 2 + 1, n + 7):
        _same(kc.compact(mask, cap, translate=translate),
              kc.compact_plain(mask, cap, translate))
    assert kc.launches["compact"] == before + 4


@pytest.mark.parametrize("n", [1, 37, 5000, 1 << 20])
@pytest.mark.parametrize("G", [1, 7, 130, 4096])
def test_filter_agg_kernel(cuda, n, G):
    rng = np.random.default_rng(n + G)
    mask = torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    gidx = torch.from_numpy(rng.integers(-1, G + 1, n).astype(np.int32)
                            ).to(cuda)
    vals = [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
            for _ in range(2)]
    _same(kf.filter_agg(mask, gidx, vals, G),
          kf.filter_agg_plain(mask, gidx, vals, G))


def _view(a, offset, dev):
    """`a[offset:]` on the card: a contiguous view at a storage offset,
    so the kernels' vector loads meet unaligned addresses."""
    return torch.from_numpy(a).to(dev)[offset:]


@pytest.mark.parametrize("G,A", [(8, 8), (9, 8), (1, 16), (6, 7)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [(1 << 20) + 3, (1 << 18) + 3])
def test_filter_agg_kernel_repeats_bit_for_bit(cuda, G, A, offset, n):
    """Two calls on the same inputs.  In the register regime (8 x 8, 1 x
    16 and q1's 6 x 7) the sums are bit-identical, with more blocks than
    the card holds at once and with fewer (2^18 rows, q12's size); across
    its boundary (9 x 8) the shared-memory regime's atomics may order the
    last bits differently, so there both calls are held to the plain
    version.  n is not a multiple of 4, and with offset 1 every column is
    a view that the kernel must read without 16-byte loads."""
    rng = np.random.default_rng(100 * G + A + offset + n)
    m = n + offset
    mask = _view(rng.random(m) < 0.6, offset, cuda)
    gidx = _view(rng.integers(-1, G + 1, m).astype(np.int32), offset, cuda)
    vals = [_view(rng.normal(size=m).astype(np.float32), offset, cuda)
            for _ in range(A)]
    want = kf.filter_agg_plain(mask, gidx, vals, G)
    first = kf.filter_agg(mask, gidx, vals, G)
    second = kf.filter_agg(mask, gidx, vals, G)
    _same(first, want)
    _same(second, want)
    assert torch.equal(first[1], second[1])
    if (G <= 8 and A <= 8) or (G == 1 and A <= 16):     # register regime
        assert torch.equal(first[0], second[0])


# a NaN in a row the mask drops (row 4), an infinity in a kept row of
# group 1 (row 2): the oracle's sums, which keep each out of every other
# group's sum
NF_MASK = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
NF_GIDX = np.array([0, 1, 1, 0, 0, 2, 2, 1], np.int32)
NF_SUMS = np.array([[6, 8], [np.inf, 20], [22, 24]], np.float32)


def _nonfinite(pad):
    """The eight rows after `pad` rows that the mask drops."""
    vals = np.arange(16, dtype=np.float32).reshape(8, 2)
    vals[4, 1] = np.nan
    vals[2, 0] = np.inf
    mask = np.concatenate([np.zeros(pad, bool), NF_MASK])
    gidx = np.concatenate([np.zeros(pad, np.int32), NF_GIDX])
    vals = np.concatenate([np.full((pad, 2), np.nan, np.float32), vals])
    return mask, gidx, vals


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("G", [3, 9])
@pytest.mark.parametrize("pad", [0, 4093])
def test_filter_agg_kernel_nonfinite_follows_the_oracle(cuda, G, pad):
    """Both kernels (the precomputed form and the generated selective
    form, whose predicate drops the NaN rows) give the plain version's
    sums bit for bit, in both regimes; the dropped rows before the eight
    are all NaN."""
    mask, gidx, vals = _nonfinite(pad)
    want = np.zeros((G, 2), np.float32)
    want[:3] = NF_SUMS
    d = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
         for k, v in [("m", mask), ("g", gidx), ("v0", vals[:, 0]),
                      ("v1", vals[:, 1])]}
    cols = [d["v0"], d["v1"]]
    got = kf.filter_agg(d["m"], d["g"], cols, G)
    plain = kf.filter_agg_plain(d["m"], d["g"], cols, G)
    assert torch.equal(_bits(got[0]), _bits(plain[0]))
    assert torch.equal(got[1], plain[1])
    assert torch.equal(_bits(got[0]).cpu(), _bits(torch.from_numpy(want)))
    scols = {"m": d["m"].to(torch.int32), "g": d["g"], "v0": d["v0"],
             "v1": d["v1"]}
    pred = fu.TileFn(Cmp("==", Col("m"), Const(1)), [])
    vfns = [fu.TileFn(Col("v0"), []), fu.TileFn(Col("v1"), [])]
    gfn = fu.GroupIndex([("g", G, 1)], G)
    got = kf.selective_filter_agg(scols, [], pred, vfns, gfn, G)
    plain = kf.selective_filter_agg_plain(scols, [], pred, vfns, gfn, G)
    assert torch.equal(_bits(got[0]), _bits(plain[0]))
    assert torch.equal(got[1], plain[1]) and int(got[2]) == 6


def _pred():
    return And(And(Cmp(">=", Col("f0"), Const(0.05)),
                   Cmp("<=", Col("f0"), Const(0.07))),
               And(Cmp("<", Col("f1"), Param("qty", "float32")),
                   CodeIn("c0", (1, 3))))


def _cols(n, dev):
    rng = np.random.default_rng(n)
    cols = {"c0": rng.integers(0, 7, n).astype(np.int32),
            "f0": (rng.integers(0, 11, n) / 100.0).astype(np.float32),
            "f1": rng.integers(1, 51, n).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}


@pytest.mark.parametrize("n", [1, 37, 5000, 1 << 20])
def test_generated_kernels(cuda, n):
    cols = _cols(n, cuda)
    pred = fu.TileFn(_pred(), ["qty"])
    vals = [fu.TileFn(Col("f0"), ["qty"])]
    gidx = fu.GroupIndex([("c0", 7, 1)], 7)
    for qty in (24.0, 30.5):            # rebinding reuses one build
        for cap in (1, n + 1):
            _same(kc.compact_pred(cols, [qty], pred, cap, translate=True),
                  kc.compact_pred_plain(cols, [qty], pred, cap, True))
        _same(kf.selective_filter_agg(cols, [qty], pred, vals, gidx, 7),
              kf.selective_filter_agg_plain(cols, [qty], pred, vals, gidx,
                                            7))
    assert len(kc._PRED_LIBS) >= 1 and len(kf._GEN_LIBS) >= 1


@pytest.mark.parametrize("n_groups,translate", [(7, False), (7, True),
                                               (1, True)])
@pytest.mark.parametrize("n", [1, 37, 5000, 1 << 20])
def test_selective_capacity_kernel(cuda, n, n_groups, translate):
    cols = _cols(n, cuda)
    pred = fu.TileFn(_pred(), ["qty"])
    vals = [fu.TileFn(Col("f0"), ["qty"]), fu.TileFn(Col("f1"), ["qty"])]
    gidx = fu.GroupIndex([("c0", 7, 1)], 7) if n_groups == 7 else None
    before = dict(kf.launches)
    for cap in (1, 64, n + 1):
        got = kf.selective_filter_agg(cols, [24.0], pred, vals, gidx,
                                      n_groups, capacity=cap,
                                      translate=translate)
        want = kf.selective_filter_agg_plain(cols, [24.0], pred, vals, gidx,
                                             n_groups, cap, translate)
        assert len(got) == len(want) == 4 + translate
        _same(got, want)
    assert kf.launches["selective_filter_agg_capacity"] == \
        before["selective_filter_agg_capacity"] + 3
    assert kf.launches["selective_filter_agg"] == \
        before["selective_filter_agg"]


@pytest.mark.parametrize("k,c", [(25, 3), (10_000, 3), (58_112, 1),
                                 (58_113, 1), (200_000, 2)])
@pytest.mark.parametrize("n", [1, 37, 1 << 20])
def test_gather_join_kernel(cuda, n, k, c):
    """Tables up to and past one block's shared memory (58,112 x 1 floats
    = 227 KB), which the kernel no longer stages there: it reads every
    table through the read-only cache (the faster where measured); keys
    out of range give zeros."""
    rng = np.random.default_rng(n + k + c)
    fk = torch.from_numpy(rng.integers(-2, k + 2, n).astype(np.int32)
                          ).to(cuda)
    table = torch.from_numpy(rng.normal(size=(k, c)).astype(np.float32)
                             ).to(cuda)
    assert not kg.staged_in_shared_memory(table)
    before = kg.launches["gather_join"]
    got = lib.gather_join(fk, table)
    assert kg.launches["gather_join"] == before + 1
    assert torch.equal(got, kg.gather_join_plain(fk, table))


@pytest.mark.parametrize("c", [1, 2, 3, 5])
def test_gather_join_kernel_unaligned_keys(cuda, c):
    """fk a view one key past a 16-byte boundary, n not a multiple of 4,
    NaN and infinity in the table: every output a bit copy of the plain
    version's."""
    n, k = 4 * 5000 + 3, 1000
    rng = np.random.default_rng(c)
    fk = _view(rng.integers(-2, k + 2, n + 1).astype(np.int32), 1, cuda)
    assert fk.data_ptr() % 16 == 4
    table = rng.normal(size=(k, c)).astype(np.float32)
    table[1, 0], table[2, c - 1] = np.nan, np.inf
    table = torch.from_numpy(table).to(cuda)
    got = lib.gather_join(fk, table)
    want = kg.gather_join_plain(fk, table)
    assert got.shape == want.shape == (n, c)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", [1, 10, 100, 1024])
@pytest.mark.parametrize("n", [1, 37, 5000, 1 << 20])
@pytest.mark.parametrize("ties", [False, True])
def test_masked_topk_kernel(cuda, n, k, ties):
    """Exact values and ids; with ties (eight distinct values) the lower
    row comes first across the kernel's 4096-row blocks."""
    rng = np.random.default_rng(n + k)
    vals = rng.choice(np.float32([-1, 0, 0.5, 2, 3, 7, 9, 11]), n) if ties \
        else rng.permutation(n).astype(np.float32)
    vals = torch.from_numpy(vals).to(cuda)
    mask = torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    before = kt.launches["masked_topk"]
    got = lib.masked_topk(vals, mask, k)
    assert kt.launches["masked_topk"] == before + 1
    want = kt.masked_topk_plain(vals, mask, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# float32 bit patterns the order must place: +-0, +-NaN (with payloads),
# +-inf, subnormals, -3e38 and its neighbours
SPECIAL_BITS = np.array(
    [0x00000000, 0x80000000, 0x7fc00000, 0xffc00000, 0x7fc00001, 0xffc00005,
     0x7f800001, 0xff800001, 0x7f800000, 0xff800000, 0x00000001, 0x80000001,
     0x007fffff, 0x807fffff, 0xff61b1e6, 0xff61b1e5, 0xff61b1e7],
    np.uint32)


def _special(n, rng):
    """n values, a third of them special bit patterns scattered over the
    rows, the rest a few repeated ordinary values (ties)."""
    vals = rng.choice(np.float32([-2.5, 0.5, 1, 3e38, -1]), n)
    at = rng.random(n) < 0.35
    vals[at] = rng.choice(SPECIAL_BITS, int(at.sum())).view(np.float32)
    return vals


@pytest.mark.parametrize("k", [1, 10, 1024])
@pytest.mark.parametrize("case", ["scattered", "all_masked", "all_equal",
                                  "k_above_n"])
def test_masked_topk_kernel_special_values(cuda, k, case):
    """The total order of `jax.lax.top_k` on the card: ids equal and
    values bitwise equal to the plain version, over 40,000 rows (ten
    4096-row tiles) with the specials crossing tile and block edges."""
    rng = np.random.default_rng(k)
    n = 700 if case == "k_above_n" else 40_000
    vals = _special(n, rng)
    if case == "all_equal":
        vals[:] = np.float32(0.5)
    mask = np.zeros(n, bool) if case == "all_masked" else rng.random(n) < 0.8
    v, m = torch.from_numpy(vals).to(cuda), torch.from_numpy(mask).to(cuda)
    got = lib.masked_topk(v, m, k)
    want = kt.masked_topk_plain(v, m, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("translate", [False, True])
def test_compact_kernel_many_tiles(cuda, p, translate):
    """1,025 tiles of the look-back scan, capacity below and above the
    count, each call 20 times: a look-back race shows as a rare wrong
    offset."""
    n = (1 << 22) + 37
    rng = np.random.default_rng(int(10 * p))
    mask = torch.from_numpy(rng.random(n) < p).to(cuda)
    count = int(mask.sum())
    for cap in (max(count // 3, 1), count + 5):
        want = kc.compact_plain(mask, cap, translate)
        for _ in range(20):
            _same(kc.compact(mask, cap, translate=translate), want)


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("translate", [False, True])
def test_compact_pred_kernel_many_tiles(cuda, p, translate):
    """The predicate evaluated inside the look-back scan (one launch),
    over 2^22 + 37 rows at densities 0, 0.5 and 1, capacity below and
    above the count, each call 20 times."""
    n = (1 << 22) + 37
    rng = np.random.default_rng(int(10 * p) + 1)
    cols = {"x": torch.from_numpy(rng.random(n, dtype=np.float32)).to(cuda)}
    pred = fu.TileFn(Cmp("<", Col("x"), Param("t", "float32")), ["t"])
    count = int(kc.compact_pred_plain(cols, [p], pred, 1)[1])
    before = kc.launches["compact_pred"]
    for cap in (max(count // 3, 1), count + 5):
        want = kc.compact_pred_plain(cols, [p], pred, cap, translate)
        for _ in range(20):
            _same(kc.compact_pred(cols, [p], pred, cap, translate=translate),
                  want)
    assert kc.launches["compact_pred"] == before + 40


@pytest.mark.parametrize("n", [1, 37, 908_340])
@pytest.mark.parametrize("n_groups", [1, 7])
def test_selective_kernel_repeats_bit_for_bit(cuda, n, n_groups):
    """The register regime folds its partials in the launch, the last
    block drawing the stream's ticket and setting it back to 0: 20 calls
    back to back, each equal to the plain version and bit-identical to
    the first (a ticket left behind would skip or misplace the fold)."""
    cols = _cols(n, cuda)
    pred = fu.TileFn(_pred(), ["qty"])
    vals = [fu.TileFn(Col("f0"), ["qty"]), fu.TileFn(Col("f1"), ["qty"])]
    gidx = fu.GroupIndex([("c0", 7, 1)], 7) if n_groups == 7 else None
    want = kf.selective_filter_agg_plain(cols, [24.0], pred, vals, gidx,
                                         n_groups)
    before = kf.launches["selective_filter_agg"]
    calls = [kf.selective_filter_agg(cols, [24.0], pred, vals, gidx,
                                     n_groups) for _ in range(20)]
    assert kf.launches["selective_filter_agg"] == before + 20
    for got in calls:
        _same(got, want)
        assert torch.equal(_bits(got[0]), _bits(calls[0][0]))
        assert torch.equal(got[1], calls[0][1]) and int(got[2]) == \
            int(want[2])


def test_fold_ticket_is_kept_per_stream(cuda):
    """Calls on a second stream draw their own ticket; both streams' sums
    are bit-identical to the default stream's."""
    n = 1 << 20
    rng = np.random.default_rng(5)
    mask = torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    gidx = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32)).to(cuda)
    vals = [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
            for _ in range(7)]
    base = kf.filter_agg(mask, gidx, vals, 6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [kf.filter_agg(mask, gidx, vals, 6) for _ in range(5)]
    torch.cuda.current_stream().wait_stream(side)
    again = [kf.filter_agg(mask, gidx, vals, 6) for _ in range(5)]
    torch.cuda.synchronize()
    for g in got + again:
        assert torch.equal(_bits(g[0]), _bits(base[0]))
        assert torch.equal(g[1], base[1])


def test_dense_4096_groups_14_values_on_card_matches_cpu(cuda):
    """G = 4096 with A = 14 does not fit one block's shared memory
    (4096 x 15 x 4 B): the wrapper takes it in two launches (13 + 1
    columns) and answers as the port does on the CPU."""
    n, G, A = (1 << 20) + 3, 4096, 14
    rng = np.random.default_rng(11)
    mask = torch.from_numpy(rng.random(n) < 0.7)
    gidx = torch.from_numpy(rng.integers(-1, G + 1, n).astype(np.int32))
    vals = [torch.from_numpy(rng.normal(size=n).astype(np.float32))
            for _ in range(A)]
    want = kf.filter_agg(mask, gidx, vals, G)               # on the CPU
    before = kf.launches["filter_agg"]
    got = kf.filter_agg(mask.to(cuda), gidx.to(cuda),
                        [v.to(cuda) for v in vals], G)
    assert kf.launches["filter_agg"] == before + 2
    assert got[0].shape == (G, A)
    _same([t.cpu() for t in got], want)


@pytest.mark.parametrize("n_groups", [1, 7])
def test_selective_wide_values_on_card_matches_cpu(cuda, n_groups):
    """17 value columns through the generated kernel: two launches (16 +
    1), counts and the total from the first."""
    n = 5000
    cols = _cols(n, cuda)
    pred = fu.TileFn(_pred(), ["qty"])
    vals = [fu.TileFn(Col("f0" if k % 2 else "f1"), ["qty"])
            for k in range(17)]
    gidx = fu.GroupIndex([("c0", 7, 1)], 7) if n_groups == 7 else None
    before = kf.launches["selective_filter_agg"]
    got = kf.selective_filter_agg(cols, [24.0], pred, vals, gidx, n_groups)
    assert kf.launches["selective_filter_agg"] == before + 2
    cpu = {k: v.cpu() for k, v in cols.items()}
    want = kf.selective_filter_agg(cpu, [24.0], pred, vals, gidx, n_groups)
    _same([t.cpu() for t in got], want)


def test_library_surface_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    n = 70_000
    mask = rng.random(n) < 0.4
    gidx = rng.integers(0, 9, n).astype(np.int32)
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    T = torch.from_numpy
    got = lib.filter_agg(T(mask).to(cuda), T(gidx).to(cuda),
                         T(vals).to(cuda), 9)
    torch.testing.assert_close(got.cpu(), lib.filter_agg(T(mask), T(gidx),
                                                         T(vals), 9),
                               rtol=1e-3, atol=1e-3)
    for g, w in zip(lib.compact_translate(T(mask).to(cuda), 4096),
                    lib.compact_translate(T(mask), 4096)):
        assert torch.equal(g.cpu(), w)
    cols = _cols(n, cuda)
    pred = fu.TileFn(_pred(), ["qty"])
    vfns = [fu.TileFn(Col("f0"), ["qty"])]
    got = lib.selective_filter_agg(cols, [24.0], pred, vfns, None, 1, 1,
                                   capacity=512, translate=True)
    want = lib.selective_filter_agg({k: v.cpu() for k, v in cols.items()},
                                    [24.0], pred, vfns, None, 1, 1,
                                    capacity=512, translate=True)
    _same([g.cpu() for g in got], want)


def test_cuda_tensor_never_takes_plain_path(cuda):
    """A kernel that cannot take its input raises instead of falling back."""
    mask = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        kc.compact(mask.to(torch.uint8), 4)
    with pytest.raises(ValueError):
        kf.filter_agg(mask, torch.zeros(10, dtype=torch.int32, device=cuda),
                      [torch.ones(10, device=cuda)], 70000)
    with pytest.raises(TypeError):
        lib.gather_join(torch.zeros(10, dtype=torch.int64, device=cuda),
                        torch.ones((4, 2), device=cuda))
    with pytest.raises(ValueError):
        lib.gather_join(torch.zeros(10, dtype=torch.int32, device=cuda),
                        torch.ones((4, 2), device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):
        lib.masked_topk(torch.ones(10, device=cuda, dtype=torch.float64),
                        mask, 3)
    with pytest.raises(ValueError, match="1024"):
        lib.masked_topk(torch.ones(10, device=cuda), mask, 1025)


@pytest.fixture(scope="module")
def sdb():
    return Database.tpch(sf=0.05, seed=0)


def test_wide_aggregation_on_card_matches_cpu(cuda, sdb):
    """ROADMAP Queue 3's plan, 17 sums beside l_returnflag, at
    opt-pallas: the engine hands the aggregation G = 3, A = 17, which the
    wrapper takes in two launches, and the answer is the CPU's."""
    from repro_torch.core import ir
    from repro_torch.core.expr import col

    def plan():
        return ir.Agg(ir.Scan("lineitem"), ["l_returnflag"],
                      [ir.AggSpec(f"s{k}", "sum", col("l_quantity"))
                       for k in range(17)])

    want = CompiledQuery(plan(), sdb, preset("opt-pallas"),
                         device="cpu").run()
    before = kf.launches["filter_agg"]
    got = CompiledQuery(plan(), sdb, preset("opt-pallas")).run()
    assert kf.launches["filter_agg"] == before + 2
    assert_same(got, want, False)


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_query_on_card_matches_cpu(cuda, sdb, qname, pname):
    """Every query the port runs, on the card against the port's CPU
    answer (sf 0.05)."""
    want = CompiledQuery(QUERIES[qname](), sdb, preset(pname),
                         device="cpu").run()
    cq = CompiledQuery(QUERIES[qname](), sdb, preset(pname))
    assert_same(cq.run(), want, qname in SORT_INSENSITIVE)
    assert cq.n_overflows == 0


@pytest.mark.parametrize("pname", ["naive", "template", "tpch", "strdict"])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_lower_rung_on_card_matches_cpu(cuda, sdb, qname, pname):
    """The generic joins and the generic (sort-based) aggregation, on the
    card against the port's CPU answer (sf 0.05)."""
    want = CompiledQuery(QUERIES[qname](), sdb, preset(pname),
                         device="cpu").run()
    got = CompiledQuery(QUERIES[qname](), sdb, preset(pname)).run()
    assert_same(got, want, qname in SORT_INSENSITIVE)


def _strategies(cq):
    from repro_torch.core import ir

    return {n.strategy for n in ir.walk(cq.plan)
            if isinstance(n, (ir.Join, ir.Agg))}


def test_exists_flag_and_bucket_gather_on_card_match_cpu(cuda, sdb):
    """q4's exists_flag semi join and q9full's bucket_gather at opt; q7's
    generic join; q13's generic left join at naive."""
    for q, pname, strategy in (("q4", "opt", "exists_flag"),
                               ("q9full", "opt", "bucket_gather"),
                               ("q7", "opt", "generic"),
                               ("q13", "naive", "generic")):
        want = CompiledQuery(QUERIES[q](), sdb, preset(pname),
                             device="cpu").run()
        cq = CompiledQuery(QUERIES[q](), sdb, preset(pname))
        assert strategy in _strategies(cq), (q, pname)
        assert_same(cq.run(), want, q in SORT_INSENSITIVE)


def _row(pname):
    import dataclasses

    return dataclasses.replace(preset(pname), layout="row")


@pytest.mark.parametrize("pname", ["naive", "opt", "opt-pallas"])
@pytest.mark.parametrize("qname", ["q1", "q6", "q12", "q19"])
def test_row_layout_on_card_matches_column_layout(cuda, sdb, qname, pname):
    """The row layout reaches the generated kernels with strided columns
    (compact_pred for q12, selective_filter_agg for q6 and q19) and, at
    opt-pallas, answers bit for bit as the column layout does on the card
    (every sum there is a kernel's fixed-order one); at naive and opt,
    whose `index_add_` sums have no fixed order on the card, to the
    repo's tolerance."""
    before = dict(kc.launches), dict(kf.launches)
    col = CompiledQuery(QUERIES[qname](), sdb, preset(pname)).run()
    mid = dict(kc.launches), dict(kf.launches)
    row = CompiledQuery(QUERIES[qname](), sdb, _row(pname)).run()
    after = dict(kc.launches), dict(kf.launches)

    def delta(a, b):
        return {k: b[i][k] - a[i][k] for i in (0, 1) for k in b[i]
                if b[i][k] != a[i][k]}

    assert delta(before, mid) == delta(mid, after)
    assert bool(delta(mid, after)) == (pname == "opt-pallas")
    if pname != "opt-pallas":
        assert_same(row, col, qname in SORT_INSENSITIVE)
        return
    assert sorted(col) == sorted(row)
    for k in col:
        np.testing.assert_array_equal(row[k], col[k], err_msg=k)


def test_generated_kernels_read_strided_columns(cuda):
    """compact_pred and selective_filter_agg over columns that are views
    into record matrices give, bit for bit, what they give over the same
    columns made contiguous."""
    n = (1 << 20) + 37
    flat = _cols(n, cuda)
    recs = {"c0": torch.stack([flat["c0"], flat["c0"] + 1], 1),
            "f": torch.stack([flat["f1"], flat["f0"], flat["f1"]], 1)}
    strided = {"c0": recs["c0"][:, 0], "f0": recs["f"][:, 1],
               "f1": recs["f"][:, 2]}
    assert not any(t.is_contiguous() for t in strided.values())
    pred = fu.TileFn(_pred(), ["qty"])
    vals = [fu.TileFn(Col("f0"), ["qty"]), fu.TileFn(Col("f1"), ["qty"])]
    gidx = fu.GroupIndex([("c0", 7, 1)], 7)
    for cap in (1, n + 1):
        got = kc.compact_pred(strided, [24.0], pred, cap, translate=True)
        want = kc.compact_pred(flat, [24.0], pred, cap, translate=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    got = kf.selective_filter_agg(strided, [24.0], pred, vals, gidx, 7)
    want = kf.selective_filter_agg(flat, [24.0], pred, vals, gidx, 7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("by_count", [False, True])
def test_topk_ties_on_card_keep_the_lowest_rows(cuda, by_count):
    """The top-k tie plans (tests/test_torch_fuzz.py) on the card: the
    same nine rows as on the CPU; by status and priority O/2-HIGH in and
    O/5-LOW out, by status and count descending O/5-LOW in and
    O/3-MEDIUM out."""
    from repro_torch.core import expr as E
    from repro_torch.core import ir
    from test_torch_fuzz import tie_plan

    db = Database.tpch(sf=0.01, seed=0)
    for pname in ("opt", "opt-pallas"):
        want = CompiledQuery(tie_plan(ir, E, by_count), db, preset(pname),
                             device="cpu").run()
        got = CompiledQuery(tie_plan(ir, E, by_count), db,
                            preset(pname)).run()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        rows = list(zip(got["o_orderstatus"], got["o_orderpriority"],
                        got["a0"].tolist()))
        kept, cut = (("O", "5-LOW", 836), ("O", "3-MEDIUM", 802)) \
            if by_count else (("O", "2-HIGH", 868), ("O", "5-LOW", 836))
        assert kept in rows and cut not in rows


# ---------------------------------------------------------------------------
# the serving path on the card (sf 0.05)
# ---------------------------------------------------------------------------

def _param(qname):
    from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                                PARAM_QUERIES)

    build, defaults = PARAM_QUERIES[qname]
    return build, dict(defaults), dict(defaults,
                                       **PARAM_ALT_BINDINGS[qname])


@pytest.mark.parametrize("qname", ["q1", "q3", "q6", "q12", "q14", "q19"])
def test_rebind_on_card_builds_no_library(cuda, sdb, qname):
    """A second binding of a parameterized plan at opt-pallas launches
    the kernels the first one built, with new scalars: no staging, no
    library built; both answers are the CPU's."""
    from repro_torch.core import PlanCache
    from repro_torch.core import compile as compile_mod
    from repro_torch.kernels import build as kbuild

    build, d, alt = _param(qname)
    cpu = PlanCache(sdb, device="cpu")
    cache = PlanCache(sdb)
    try:
        got = cache.execute(build(), preset("opt-pallas"), d)
        assert_same(got, cpu.execute(build(), preset("opt"), d), True)
        stagings, libs = compile_mod.STAGINGS, len(kbuild._LIBS)
        got = cache.execute(build(), preset("opt-pallas"), alt)
        assert_same(got, cpu.execute(build(), preset("opt"), alt), True)
        assert compile_mod.STAGINGS == stagings
        assert len(kbuild._LIBS) == libs
    finally:
        cache.close()


@pytest.mark.parametrize("qname", ["q3", "q6", "q12"])
def test_execute_many_on_card_equals_run(cuda, sdb, qname):
    from repro_torch.core import PlanCache

    build, d, alt = _param(qname)
    cache = PlanCache(sdb)
    try:
        bindings = [d, alt, alt, d, alt]
        many = cache.execute_many(build(), preset("opt-pallas"), bindings)
        cq, _ = cache.get(build(), preset("opt-pallas"), d)
        for got, b in zip(many, bindings):
            want = cq.run({k: b[k] for k in cq.param_spec})
            if qname == "q3":
                # q3's dense aggregation adds with atomics (`index_add_`),
                # in no fixed order: the repo's rule, not bit for bit
                assert_same(got, want, False)
            else:
                # q6 and q12 sum in the kernels' fixed order
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
    finally:
        cache.close()


def test_server_on_card_answers_as_the_cpu(cuda, sdb):
    from repro_torch.relational.queries import PARAM_QUERIES
    from repro_torch.serve.query_server import QueryServer

    reqs = []
    for q in sorted(PARAM_QUERIES):
        build, d, alt = _param(q)
        reqs += [(build(), d), (build(), alt)]
    with QueryServer(sdb, preset("opt-pallas"), window_s=3600.0) as srv:
        futs = [srv.submit(p, b) for p, b in reqs]
        srv.flush()
        got = [f.result(timeout=600) for f in futs]
    with QueryServer(sdb, preset("opt"), window_s=3600.0,
                     device="cpu") as srv:
        futs = [srv.submit(p, b) for p, b in reqs]
        srv.flush()
        want = [f.result(timeout=600) for f in futs]
    for g, w in zip(got, want):
        assert_same(g, w, True)


def test_eviction_releases_the_entry_device_memory(cuda, sdb):
    """An entry's resident inputs go back to the allocator when the
    cache evicts it (or closes), once the caller drops it too."""
    import gc

    from repro_torch.core import PlanCache

    cache = PlanCache(sdb, max_entries=1)
    try:
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cq, _ = cache.get(QUERIES["q1"](), preset("opt-pallas"))
        resident = sum(t.numel() * t.element_size()
                       for t in cq.resident.values())
        assert resident > 1 << 20
        assert torch.cuda.memory_allocated() >= base + resident
        del cq
        cq, _ = cache.get(QUERIES["q6"](), preset("opt-pallas"))  # evicts q1
        kept = sum(t.numel() * t.element_size()
                   for t in cq.resident.values())
        del cq
        assert cache.stats.evictions == 1
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() <= base + kept + (1 << 20)
        cache.close()
        gc.collect()
        assert torch.cuda.memory_allocated() <= base + (1 << 20)
    finally:
        cache.close()


def test_failed_promotion_on_card_raises(cuda, sdb):
    """A tiered cache on the card whose promotion fails (here a compile
    fault injected through the server's `compile_hook`) answers the
    shape's later requests with the failure, never from the host
    oracle."""
    from repro_torch.core.plan_cache import PromotionFailed
    from repro_torch.relational.queries import PARAM_QUERIES
    from repro_torch.serve.query_server import QueryServer

    build, d = PARAM_QUERIES["q6"]

    def boom(key):
        raise RuntimeError("injected compile fault")

    with QueryServer(sdb, preset("opt-pallas"), tiered=True,
                     window_s=0.001, compile_hook=boom) as srv:
        first = srv.submit(build(), d)
        try:
            first.result(timeout=600)     # the oracle, or already the fault
        except PromotionFailed:
            pass
        assert not srv.cache.await_promotion(build(), preset("opt-pallas"),
                                             d, timeout=600)
        with pytest.raises(PromotionFailed):
            srv.submit(build(), d).result(timeout=600)
        assert srv.cache.stats.promote_failures == 1
        assert srv.stats.errors >= 1


@pytest.fixture
def two_slots(cuda):
    """Two mesh slots on the card: two CUDA devices when the machine has
    them, else two virtual slots on cuda:0."""
    from repro_torch.core import mesh

    if torch.cuda.device_count() < 2:
        mesh.virtual_devices("cuda:0", 2)
    yield
    mesh.virtual_devices("cuda:0", 1)


@pytest.mark.parametrize("qname", ["q1", "q3", "q6", "q12", "q19"])
def test_sharded_query_on_card_matches_unsharded(cuda, sdb, two_slots,
                                                 qname):
    """A query on a 2-shard mesh of the card at opt-pallas (sf 0.05): the
    unsharded card answer, every shard's output the same bits, and every
    engine call a launch of its kernel."""
    import dataclasses

    import repro_torch.kernels.ops as kops

    want = CompiledQuery(QUERIES[qname](), sdb, preset("opt-pallas")).run()
    cq = CompiledQuery(QUERIES[qname](), sdb, dataclasses.replace(
        preset("opt-pallas"), shards=2))
    assert cq.n_shards == 2
    calls = sum(kops.calls.values())
    launches = sum(kc.launches.values()) + sum(kf.launches.values())
    for _ in range(2):
        assert_same(cq.run(), want, qname in SORT_INSENSITIVE)
    assert cq.n_overflows == 0
    assert (sum(kc.launches.values()) + sum(kf.launches.values())
            - launches) == sum(kops.calls.values()) - calls
    (out0, mask0, _), (out1, mask1, _) = cq.execute_shards(cq.bind())
    assert torch.equal(mask0, mask1.to(mask0.device))
    for k in out0:
        assert torch.equal(out0[k], out1[k].to(out0[k].device)), k
