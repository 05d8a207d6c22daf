"""The two batched kernels that read the bindings' shared columns once, on
the card: `filter_agg_batched` in the staged register regime (the group
index and the value columns multicast to a cluster of bindings, each
binding's mask read by its own warp) and
`compact_pred_batched` over a tile that serves every binding (the
predicate's parameter-free conjuncts evaluated once a row).  Each
against its batched plain version and, slot by slot, against the scalar
kernel on that binding's operands, on both routes: shared operands, and
a batched group index or column.

Run on a machine with an NVIDIA Hopper card and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_batched_shared_columns_cuda.py

Without CUDA every test here skips (the decision is taken inside the
`cuda` fixture, never at import).  This file does not import JAX: the
plain versions are the oracle.  Compactions must match exactly; float
sums against the plain version within rtol 1e-3, atol 1e-3 (the kernels
and `index_add_` add in different orders), and against the scalar
kernel bit for bit.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.expr import (And, Cmp, CodeIn, Col, Const, Or, Param,
                                   expr_columns)
from repro_torch.core.operators import fused as fu

pytestmark = pytest.mark.cuda

kc = importlib.import_module("repro_torch.kernels.compact")
kf = importlib.import_module("repro_torch.kernels.filter_agg")

TILE = kc.TILE_ROWS
# phase 4c's bindings, a block and a cluster and a half of them
BINDINGS = [1, 7, 9, 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counted(counter: dict, route: str, fn):
    before = dict(counter)
    out = fn()
    assert counter[route] == before[route] + 1, (route, counter, before)
    return out


# ---------------------------------------------------------------------------
# filter_agg_batched
# ---------------------------------------------------------------------------

def _agg_case(B: int, n: int, G: int, A: int, dev, offset: int = 0,
              batched: str = "", seed: int = 0):
    """A batched mask (each binding's rows `offset` bytes into a row of n +
    offset, so with odd n + offset every other binding's mask starts at an
    odd address), a shared group index with out-of-range entries and A
    shared value columns with a NaN in a dropped row and an infinity in a
    kept one; `batched` names the operands made (B, n) instead."""
    rng = np.random.default_rng(seed + n + B + G + A)
    m = rng.random((B, n + offset)) < np.linspace(0.0, 1.0, B)[:, None]
    g = rng.integers(-1, G + 1, n).astype(np.int32)
    vals = [rng.normal(size=n).astype(np.float32) for _ in range(A)]
    if A and n > 8:
        m[:, offset + 3] = False
        vals[0][3] = np.nan
        vals[0][5] = np.inf
        g[5] = 0
    gidx = torch.from_numpy(g).to(dev)
    values = [torch.from_numpy(v).to(dev) for v in vals]
    mask = torch.from_numpy(m).to(dev)[:, offset:]
    if "gidx" in batched:
        gidx = gidx.expand(B, n).contiguous()
    if "values" in batched and values:
        values[-1] = values[-1].expand(B, n).contiguous()
    return mask, gidx, values


def _check_agg(mask, gidx, values, G, route):
    got = _counted(kf.filter_agg_staging, route,
                   lambda: kf.filter_agg_batched(mask, gidx, values, G))
    want = kf.filter_agg_batched_plain(mask, gidx, values, G)
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1e-3,
                               equal_nan=True)
    assert torch.equal(got[1], want[1])
    for b in range(mask.shape[0]):
        one = kf.filter_agg(kc.binding(mask, b, 1).contiguous(),
                            kc.binding(gidx, b, 1),
                            [kc.binding(v, b, 1) for v in values], G)
        assert torch.equal(got[0][b].view(torch.int32),
                           one[0].view(torch.int32)), b
        assert torch.equal(got[1][b], one[1]), b


@pytest.mark.parametrize("B", BINDINGS)
@pytest.mark.parametrize("n", [127, 128 * 1024 + 1, 3_000_017, 5_999_771])
def test_filter_agg_staged_bindings(cuda, n, B):
    """q14's shape (one group, two values) on the staged route, odd n so
    that every other binding's mask is unaligned: every slot the scalar
    kernel's bit for bit."""
    mask, gidx, values = _agg_case(B, n, 1, 2, cuda)
    _check_agg(mask, gidx, values, 1, "staged")


@pytest.mark.parametrize("G,A", [(1, 0), (1, 1), (1, 3), (1, 5), (1, 16),
                                 (3, 2), (8, 8)])
def test_filter_agg_staged_shapes(cuda, G, A):
    """Every instance of the staged register step: one group with 1, 2,
    4, 8 or 16 value slots (A rounded up), and up to 8 groups of 8."""
    mask, gidx, values = _agg_case(9, 1_000_003, G, A, cuda)
    _check_agg(mask, gidx, values, G, "staged")


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_filter_agg_staged_mask_offsets(cuda, offset):
    """Each binding's mask at another offset of a 16-byte granule (the
    aligned words a lane funnels its quad from)."""
    mask, gidx, values = _agg_case(7, 2_000_001, 1, 2, cuda, offset=offset)
    _check_agg(mask, gidx, values, 1, "staged")


@pytest.mark.parametrize("batched", ["gidx", "values", "unaligned"])
def test_filter_agg_unstaged_route(cuda, batched):
    """A batched group index or value column, or a shared column at an
    unaligned address: the block-a-binding kernel, still the scalar
    kernel's sums bit for bit."""
    n, B = 1_000_003, 9
    mask, gidx, values = _agg_case(B, n, 1, 2, cuda, batched=batched)
    if batched == "unaligned":
        wide = torch.cat([values[1][:1], values[1]])
        values[1] = wide[1:]
        assert values[1].data_ptr() % 16
    _check_agg(mask, gidx, values, 1, "unstaged")


def test_filter_agg_staged_info(cuda):
    """The staged instance reports its route, clusters and ring."""
    mask, gidx, values = _agg_case(64, 50_001, 1, 2, cuda)
    info = kf.filter_agg_batched_info(mask, gidx, values, 1)
    assert info["route"] == "staged"
    assert (info["cluster"], info["padded_bindings"]) == kf.cluster_shape(64)
    assert info["warps"] == 16 and info["active_clusters"] > 0
    assert info["stages"] >= 2 and info["stage_smem_bytes"] > 0


# ---------------------------------------------------------------------------
# compact_pred_batched
# ---------------------------------------------------------------------------

def _q12_pred():
    """q12's shape: codes and two column comparisons free of parameters,
    a parameterised date window."""
    return And(And(CodeIn("m", (1, 3)), Cmp("<", Col("c"), Col("r"))),
               And(Cmp("<", Col("s"), Col("c")),
                   And(Cmp(">=", Col("r"), Param("lo", "int32")),
                       Cmp("<", Col("r"), Param("hi", "int32")))))


def _or_pred():
    """No free conjunct: the whole predicate a binding's."""
    return Or(Cmp("<", Col("f"), Param("qty", "float32")),
              CodeIn("m", (2,)))


def _free_pred():
    """No parameter: every binding the same answer."""
    return And(Cmp("<", Col("s"), Col("c")), Cmp(">", Col("f"), Const(10.0)))


def _wide_pred():
    """Bound conjuncts over three columns: a 48 KB copy of the tile in
    shared memory beside the kernel's own (past the default 48 KB)."""
    return And(CodeIn("m", (1, 3, 5)),
               And(Cmp(">=", Col("r"), Param("lo", "int32")),
                   And(Cmp("<", Col("c"), Param("hi", "int32")),
                       Cmp(">", Col("s"), Param("lo", "int32")))))


PREDS = {"q12": (_q12_pred, ["lo", "hi"]), "or": (_or_pred, ["qty"]),
         "free": (_free_pred, []), "wide": (_wide_pred, ["lo", "hi"])}


def _pred_case(B: int, n: int, dev, which: str, offset: int = 0,
               batched: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed + n + B)
    cols = {"m": rng.integers(0, 7, n + offset).astype(np.int32),
            "c": rng.integers(8000, 10600, n + offset).astype(np.int32),
            "s": rng.integers(8000, 10600, n + offset).astype(np.int32),
            "f": rng.integers(1, 51, n + offset).astype(np.float32)}
    cols["r"] = cols["c"] + rng.integers(-30, 60, n + offset).astype(
        np.int32)
    build, names = PREDS[which]
    pred = build()
    used = sorted(expr_columns(pred))
    t = {k: torch.from_numpy(cols[k]).to(dev)[offset:] for k in used}
    if batched:
        k0 = used[0]
        t[k0] = t[k0].expand(B, n).contiguous()
    if which in ("q12", "wide"):
        lo = rng.integers(8000, 10400, B)
        params = [torch.from_numpy(lo.astype(np.int32)).to(dev),
                  torch.from_numpy((lo + rng.integers(0, 400, B))
                                   .astype(np.int32)).to(dev)]
    elif which == "or":
        params = [torch.from_numpy(rng.integers(0, 50, B).astype(np.float32)
                                   + 0.5).to(dev)]
    else:
        params = []
    fp, ip, kinds = kc.param_vectors(params)
    if not params:            # no parameter: B empty parameter rows
        fp = torch.zeros((B, 0), dtype=torch.float64, device=dev)
        ip = torch.zeros((B, 0), dtype=torch.int64, device=dev)
    return t, fp, ip, kinds, fu.TileFn(pred, names)


def _check_pred(cols, fp, ip, kinds, pred, cap, translate, route):
    got = _counted(kc.staging, route, lambda: kc.compact_pred_batched(
        cols, fp, ip, kinds, pred, cap, translate=translate))
    want = kc.compact_pred_batched_plain(cols, fp, ip, kinds, pred, cap,
                                         translate)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    B = got[1].shape[0]
    for b in range(B):
        one = kc.compact_pred({k: kc.binding(v, b, 1) for k, v in
                               cols.items()},
                              kc.binding_scalars(fp, ip, kinds, b), pred, cap,
                              translate=translate)
        assert all(torch.equal(g[b], w) for g, w in zip(got, one)), b


@pytest.mark.parametrize("translate", [False, True])
@pytest.mark.parametrize("B", BINDINGS)
@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 3 * TILE + 17,
                               1_000_003])
def test_compact_pred_tile_bindings(cuda, n, B, translate):
    """q12's predicate on the shared-tile route: every binding's ids,
    count, pad zeros and slot_of, at a capacity inside the counts and one
    past every row (the pad shares zero most of idx)."""
    cols, fp, ip, kinds, pred = _pred_case(B, n, cuda, "q12")
    for cap in (n // 50 + 1, n + 7):
        _check_pred(cols, fp, ip, kinds, pred, cap, translate, "staged")


@pytest.mark.parametrize("which", ["or", "free", "wide"])
@pytest.mark.parametrize("offset", [0, 3])
def test_compact_pred_tile_predicates(cuda, which, offset):
    """A predicate with no free conjunct, one with no parameter (every
    binding the same) and one whose bound columns take 48 KB of shared
    memory, over columns at a row offset."""
    cols, fp, ip, kinds, pred = _pred_case(5, 200_003, cuda, which, offset)
    _check_pred(cols, fp, ip, kinds, pred, 60_000, True, "staged")


def test_compact_pred_unstaged_route(cuda):
    """A column that differs by binding: the look-back scan's binding
    axis, still every binding the scalar kernel's output."""
    cols, fp, ip, kinds, pred = _pred_case(9, 300_007, cuda, "q12",
                                           batched=True)
    _check_pred(cols, fp, ip, kinds, pred, 20_000, True, "unstaged")


def test_compact_pred_tile_many_calls_agree(cuda):
    """The look-back under many tiles a binding: 20 calls of B = 64 over
    2^22 + 37 rows against one plain answer."""
    cols, fp, ip, kinds, pred = _pred_case(64, (1 << 22) + 37, cuda, "q12")
    want = kc.compact_pred_batched_plain(cols, fp, ip, kinds, pred, 100_000,
                                         False)
    for _ in range(20):
        got = kc.compact_pred_batched(cols, fp, ip, kinds, pred, 100_000)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
