"""The two redesigned batched kernels on the card: `compact_batched` (the
wide-tile vector scan) and `selective_filter_agg_batched` (shared
columns multicast to a cluster of bindings), each against its batched
plain version and, slot by slot, bit for bit against the scalar kernel
on that binding's operands.

Run on a machine with an NVIDIA Hopper card and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_batched_staging_cuda.py

Without CUDA every test here skips (the decision is taken inside the
`cuda` fixture, never at import).  This file does not import JAX: the
plain versions are the oracle.  Integer outputs must match exactly;
float sums against the plain version within rtol 1e-3, atol 1e-3 (the
kernels and `index_add_` add in different orders), and against the
scalar kernel bit for bit.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.expr import And, Arith, Cmp, CodeIn, Col, Const, Param
from repro_torch.core.operators import fused as fu
from repro_torch.kernels import codegen

pytestmark = pytest.mark.cuda

kc = importlib.import_module("repro_torch.kernels.compact")
kf = importlib.import_module("repro_torch.kernels.filter_agg")

TILE = kc.BATCH_TILE_ROWS
SLICE = codegen.SLICE_ROWS
# the bindings of phase 4c of chip_smoke.py and a cluster and a half
BINDINGS = [1, 7, 9, 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want):
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
        else:
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# compact_batched
# ---------------------------------------------------------------------------

def _masks(B: int, n: int, seed: int) -> np.ndarray:
    """B masks cycling through densities 0, 0.003, 0.5 and 1."""
    rng = np.random.default_rng(seed)
    dens = np.array([0.0, 0.003, 0.5, 1.0])[np.arange(B) % 4]
    return rng.random((B, n)) < dens[:, None]


def _check_compact(mask, cap, translate):
    before = kc.launches["compact_batched"]
    got = kc.compact_batched(mask, cap, translate=translate)
    assert kc.launches["compact_batched"] == before + 1
    _close(got, kc.compact_batched_plain(mask, cap, translate))
    for b in range(mask.shape[0]):
        one = kc.compact(mask[b].contiguous(), cap, translate=translate)
        assert all(torch.equal(g[b], w) for g, w in zip(got, one)), b


@pytest.mark.parametrize("translate", [False, True])
@pytest.mark.parametrize("B", BINDINGS)
@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 3 * TILE - 1,
                               3 * TILE, 3 * TILE + 1])
def test_compact_batched_at_tile_boundaries(cuda, n, B, translate):
    """Every binding's ids, count, pad zeros and slot_of, at a capacity
    that overflows, one inside the counts and one past every row (pad
    blocks zero most of idx); (B, n) rows of odd n start at unaligned
    addresses."""
    mask = torch.from_numpy(_masks(B, n, seed=n + B)).to(cuda)
    for cap in (1, n // 3 + 1, n + 7, 2 * kc.BATCH_PAD_WORDS + 5):
        _check_compact(mask, cap, translate)


@pytest.mark.parametrize("offset", [0, 1, 5])
def test_compact_batched_shared_and_offset_masks(cuda, offset):
    """A mask every binding shares (binding stride 0) and rows at a
    storage offset (each binding's first row at another alignment)."""
    n = 2 * TILE + 37
    rng = np.random.default_rng(offset)
    base = torch.from_numpy(rng.random(n + offset) < 0.4).to(cuda)
    shared = base[offset:].expand(5, n)
    assert shared.stride(0) == 0
    _check_compact(shared, n // 2, True)
    rows = torch.from_numpy(rng.random((6, n + offset)) < 0.6).to(cuda)
    _check_compact(rows[:, offset:], n, True)


def test_compact_batched_many_calls_agree(cuda):
    """The look-back under many tiles a binding, 20 calls of B = 8 over
    2^22 + 37 rows against one plain answer."""
    n = (1 << 22) + 37
    mask = torch.from_numpy(_masks(8, n, seed=3)).to(cuda)
    want = kc.compact_batched_plain(mask, n // 3, True)
    for _ in range(20):
        _close(kc.compact_batched(mask, n // 3, translate=True), want)


# ---------------------------------------------------------------------------
# selective_filter_agg_batched
# ---------------------------------------------------------------------------

def _pred():
    return And(And(Cmp("<", Col("f1"), Param("qty", "float32")),
                   CodeIn("c0", (1, 3, 4, 6))),
               Cmp(">=", Col("u"), Const(0.0)))


def _sel_case(B: int, n: int, dev, batched_cols: bool = False,
              strided: bool = False, seed: int = 0):
    """Operands of a batched selective call: shared contiguous columns
    (c0, f1, v), a shared column at an unaligned address (u), one batched
    column (fb), and a batched parameter; a NaN in a dropped row and an
    infinity in a kept row of the value column v.  `batched_cols` makes
    every column batched, `strided` reads c0, f1 and v from a record
    matrix (the row layout)."""
    rng = np.random.default_rng(seed + n + B)
    c0 = rng.integers(0, 7, n).astype(np.int32)
    f1 = rng.integers(1, 51, n).astype(np.float32)
    v = rng.normal(size=n).astype(np.float32)
    u = rng.normal(size=n + 1).astype(np.float32)
    if n > 8:
        c0[3], f1[3], v[3] = 0, 1.0, np.nan          # dropped
        c0[5], f1[5], u[6], v[5] = 1, 1.0, 1.0, np.inf   # kept
    fb = rng.normal(size=(B, n)).astype(np.float32)
    t = (lambda a: torch.from_numpy(a).to(dev))
    cols = {"c0": t(c0), "f1": t(f1), "v": t(v), "u": t(u)[1:], "fb": t(fb)}
    if strided:
        rec = torch.stack([cols["c0"].float(), cols["f1"], cols["v"]], 1)
        cols.update(c0=cols["c0"], f1=rec[:, 1], v=rec[:, 2])
    if batched_cols:
        cols = {k: x if x.ndim == 2 else x.expand(B, n).contiguous()
                for k, x in cols.items()}
    qty = torch.from_numpy(rng.integers(5, 45, B).astype(np.float32) + 0.5
                           ).to(dev)
    fp, ip, kinds = kc.param_vectors([qty])
    return cols, fp, ip, kinds


def _sel_fns(grouped: bool):
    pred = fu.TileFn(_pred(), ["qty"])
    if grouped:
        vals = [fu.TileFn(e, ["qty"]) for e in (
            Col("v"), Arith("*", Col("f1"), Col("fb")), Col("u"))]
        return pred, vals, fu.GroupIndex([("c0", 7, 1)], 7), 7
    return pred, [fu.TileFn(Arith("*", Col("v"), Col("fb")), ["qty"])], \
        None, 1


def _check_selective(cols, fp, ip, kinds, grouped, staged: bool):
    pred, vals, gidx, G = _sel_fns(grouped)
    before = dict(kf.staging)
    got = kf.selective_filter_agg_batched(cols, fp, ip, kinds, pred, vals,
                                          gidx, G)
    assert kf.staging["staged" if staged else "unstaged"] == \
        before["staged" if staged else "unstaged"] + 1
    want = kf.selective_filter_agg_batched_plain(cols, fp, ip, kinds, pred,
                                                 vals, gidx, G)
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1e-3,
                               equal_nan=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    B = got[1].shape[0]
    for b in range(B):
        one = kf.selective_filter_agg(
            {k: kc.binding(v, b, 1) for k, v in cols.items()},
            kc.binding_scalars(fp, ip, kinds, b), pred, vals, gidx, G)
        assert torch.equal(got[0][b].view(torch.int32),
                           one[0].view(torch.int32)), b
        assert torch.equal(got[1][b], one[1]) and int(got[2][b]) == \
            int(one[2]), b


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("B", BINDINGS)
@pytest.mark.parametrize("n", [SLICE - 1, SLICE, SLICE + 1, 8 * SLICE - 1,
                               8 * SLICE + 1, 4 * 8 * SLICE + 3,
                               (1 << 21) + 5, 3_000_017])
def test_selective_batched_staged(cuda, n, B, grouped):
    """Shared aligned columns staged, the unaligned and the batched one
    from device memory: every slot the scalar kernel's bit for bit, the
    plain version's within tolerance, across partial slices and the
    tail rows."""
    cols, fp, ip, kinds = _sel_case(B, n, cuda)
    _check_selective(cols, fp, ip, kinds, grouped, staged=True)


@pytest.mark.parametrize("layout", ["batched", "strided"])
@pytest.mark.parametrize("B", [3, 64])
def test_selective_batched_unstaged(cuda, B, layout):
    """Every column batched, or the row layout's strided columns beside
    the unaligned one: the cluster launch with nothing (or less) staged,
    still the scalar kernel's sums bit for bit."""
    n = 100_003
    cols, fp, ip, kinds = _sel_case(B, n, cuda,
                                    batched_cols=layout == "batched",
                                    strided=layout == "strided")
    pred, vals, gidx, G = _sel_fns(True)
    staged = bool(kf.staged_columns(cols, G, len(vals)))
    assert staged == (layout == "strided")      # c0 stays contiguous
    _check_selective(cols, fp, ip, kinds, True, staged)


def test_selective_batched_info(cuda):
    """The staged instance reports its clusters, ring and staged
    columns."""
    cols, fp, ip, kinds = _sel_case(64, 50_000, cuda)
    pred, vals, gidx, G = _sel_fns(True)
    info = kf.selective_batched_info(cols, fp, ip, kinds, pred, vals, gidx,
                                     G)
    assert (info["cluster"], info["padded_bindings"]) == kf.cluster_shape(64)
    assert info["warps"] == kf.staged_warps(64) == 16
    assert info["active_clusters"] > 0 and info["stages"] >= 2
    assert info["staged"] == ["c0", "f1", "v"]
    assert info["stage_smem_bytes"] == \
        info["stages"] * kf.STEPS_PER_SLOT * 3 * 4 * SLICE
