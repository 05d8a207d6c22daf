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
    """Tables staged in shared memory (up to 58,112 x 1 floats = 227 KB)
    and read from device memory; keys out of range give zeros."""
    rng = np.random.default_rng(n + k + c)
    fk = torch.from_numpy(rng.integers(-2, k + 2, n).astype(np.int32)
                          ).to(cuda)
    table = torch.from_numpy(rng.normal(size=(k, c)).astype(np.float32)
                             ).to(cuda)
    assert kg.staged_in_shared_memory(table) == (k * c * 4 <= 227 * 1024)
    before = kg.launches["gather_join"]
    got = lib.gather_join(fk, table)
    assert kg.launches["gather_join"] == before + 1
    assert torch.equal(got, kg.gather_join_plain(fk, table))


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


@pytest.mark.parametrize("pname", ["opt", "opt-pallas"])
@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q6", "q9", "q10",
                                   "q12", "q13", "q14", "q17", "q18",
                                   "q19"])
def test_query_on_card_matches_cpu(cuda, sdb, qname, pname):
    """Every query the port runs, on the card against the port's CPU
    answer (sf 0.05)."""
    want = CompiledQuery(QUERIES[qname](), sdb, preset(pname),
                         device="cpu").run()
    cq = CompiledQuery(QUERIES[qname](), sdb, preset(pname))
    assert_same(cq.run(), want, qname in SORT_INSENSITIVE)
    assert cq.n_overflows == 0
