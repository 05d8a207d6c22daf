"""The CPU side of the two batched kernels that read the bindings' shared
columns once: what the wrappers decide in Python, what the generator
emits, models of what the kernels do, and the plain batched versions at
the new layouts' boundaries.

  * `filter_agg_batched`'s staged register regime: which operand
    patterns take it (`staged_operands`: the group index and the value
    columns shared, contiguous and 16-byte aligned, the mask anything),
    and a model of a binding's mask fetch (`ColumnStage` in
    `csrc/filter_agg.cuh`: at every skew, the aligned words a lane loads
    around its quad, never past the mask's allocation, funnelled back
    into the quad's bytes);
  * `compact_pred_batched`'s shared-tile scan: which patterns take it
    (`shared_tile`), the predicate's split into the conjuncts that read
    no parameter and those that do (`codegen.split_predicate`), the
    generated `Tile`'s text and, compiled as host C++, `free_pred AND
    bound_pred` (the latter over the tile's shared-memory copy) equal to
    the row functor for every binding, on NaN, infinities, subnormals and
    every column type; a numpy model of the kernel (one ticket, per-binding
    look-back, each lane's groups, pad shares) whose workspace rows hold
    the plain version's packed output;
  * both plain batched versions against `jax.vmap` of the reference's
    Pallas kernels in interpret mode at n = tile - 1, tile and tile + 1
    (the compaction's 4,096 rows, the aggregation's 128-row slice) and at
    odd n, B = 1, 7, 9 and 64, with translate and past the capacity.

The card's own checks are in `test_torch_batched_shared_columns_cuda.py`.
Tolerances: integer outputs exact; float sums rtol 1e-5, atol 1e-4 (as
`test_torch_kernels`).
"""
import importlib
import re
import shutil
import subprocess

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
from repro_torch.kernels import codegen
from repro_torch.kernels.build import CSRC
from test_torch_kernels import ATOL, RTOL, T

kc = importlib.import_module("repro_torch.kernels.compact")
kf = importlib.import_module("repro_torch.kernels.filter_agg")

TILE = codegen.TILE_ROWS
SLICE = codegen.SLICE_ROWS
BINDINGS = [1, 7, 9, 64]


def _constant(header: str, name: str) -> int:
    text = (CSRC / header).read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    expr = m.group(1).split("//")[0]
    for dep in set(re.findall(r"\bk[A-Za-z]+\b", expr)):
        for h in ("compact.cuh", "filter_agg.cuh", "common.cuh"):
            if re.search(rf"constexpr int {dep} =", (CSRC / h).read_text()):
                expr = re.sub(rf"\b{dep}\b", str(_constant(h, dep)), expr)
                break
    return int(eval(expr, {}))


def test_python_mirrors_the_headers():
    """The wrappers' and the generator's copies of the kernels' tile,
    groups and pad share."""
    assert TILE == kc.TILE_ROWS == _constant("compact.cuh", "kCompactRows")
    assert _constant("compact.cuh", "kTileGroups") == TILE // 32
    assert _constant("compact.cuh", "kTileLaneGroups") == TILE // 32 // 32
    assert kc.BATCH_PAD_WORDS == _constant("compact.cuh", "kBatchPadWords")
    assert SLICE == _constant("filter_agg.cuh", "kStageRows")


# ---------------------------------------------------------------------------
# filter_agg_batched: the staged route
# ---------------------------------------------------------------------------

def test_staged_operands():
    """Staged: the group index and every value column shared, contiguous
    and 16-byte aligned, in the register regime, whatever the mask;
    else the block-a-binding kernel."""
    n, B = 5000, 4
    buf = torch.zeros(n + 8)
    g = torch.zeros(n + 4, dtype=torch.int32)
    v = [buf[:n], torch.ones(n)]
    gidx = g[:n]
    mask_b = torch.ones((B, n + 1), dtype=torch.bool)[:, 1:]
    mask_s = torch.ones(n, dtype=torch.bool)
    for mask in (mask_b, mask_s):
        assert kf.staged_operands(mask, gidx, v, 1)
        assert kf.staged_operands(mask, gidx, v[:1], 8)
        assert kf.staged_operands(mask, gidx, [], 1)
    assert kf.staged_operands(mask_b, gidx, [torch.ones(n)] * 16, 1)
    assert not kf.staged_operands(mask_b, gidx, [torch.ones(n)] * 17, 1)
    assert not kf.staged_operands(mask_b, gidx, v, 9)       # shared memory
    assert not kf.staged_operands(mask_b, gidx, [torch.ones(n)] * 9, 2)
    assert not kf.staged_operands(mask_b, torch.zeros((B, n),
                                                      dtype=torch.int32),
                                  v, 1)                    # batched gidx
    assert not kf.staged_operands(mask_b, gidx, [v[0], torch.ones((B, n))],
                                  1)                       # batched value
    assert not kf.staged_operands(mask_b, gidx, [buf[1:n + 1]], 1)
    assert not kf.staged_operands(mask_b, g[1:n + 1], v, 1)
    assert not kf.staged_operands(mask_b, gidx,
                                  [torch.zeros((n, 3))[:, 1]], 1)   # strided
    assert kf.staged_operands(mask_b, g[4:n + 4], [buf[4:n + 4]], 1)


def _fetch_quad(mem: np.ndarray, a: int):
    """ColumnStage's fetch and load_fetched of the quad at byte `a` of
    `mem`: the aligned word that holds byte a and, where a is not 4-byte
    aligned, the next one, funnelled right by a's offset; returns the
    words' byte offsets and the quad's four predicates."""
    s = a % 4
    words = [a - s] + ([a - s + 4] if s else [])
    w0 = int(mem[a - s:a - s + 4].view("<u4")[0])
    w1 = int(mem[a - s + 4:a - s + 8].view("<u4")[0]) if s else 0
    v = ((w1 << 32 | w0) >> (8 * s)) & 0xFFFFFFFF
    return words, [((v >> (8 * r)) & 0xFF) != 0 for r in range(4)]


@pytest.mark.parametrize("skew", range(16))
def test_mask_fetch_at_every_skew(skew):
    """Every binding's quads of a (B, n) mask of odd n whose first row
    starts `skew` bytes into a 16-byte granule: each word a lane loads is
    aligned and holds a byte of its quad (so it never leaves the mask's
    allocation, at the first binding's first quad and the last binding's
    last one), and the funnelled word reads back the quad's rows."""
    rng = np.random.default_rng(skew)
    n, B = 3 * SLICE + 5, 3
    base = 16 + skew
    # the allocation: the 16-byte granules that hold the masks' bytes
    mem = np.zeros(-(-(base + B * n) // 16) * 16 + 8, np.uint8)
    end = -(-(base + B * n) // 16) * 16
    mem[base:base + B * n] = rng.integers(0, 2, B * n) * \
        rng.integers(1, 256, B * n)
    for b in range(B):
        addr = base + b * n
        for q in range(n // 4):
            a = addr + 4 * q
            words, bits = _fetch_quad(mem, a)
            for w in words:
                assert w % 4 == 0 and 16 <= w and w + 4 <= end
                assert w <= a + 3 and a < w + 4      # a byte of the quad
            assert bits == list(mem[a:a + 4] != 0)


# ---------------------------------------------------------------------------
# compact_pred_batched: the route and the split predicate
# ---------------------------------------------------------------------------

def _q12(E):
    """q12's predicate shape: codes and two column comparisons free of
    parameters, the receipt-date window bound to each binding."""
    col = E.Col
    return E.And(E.And(E.CodeIn("m", (1, 3)), E.Cmp("<", col("c"), col("r"))),
                 E.And(E.Cmp("<", col("s"), col("c")),
                       E.And(E.Cmp(">=", col("r"), E.Param("lo", "int32")),
                             E.Cmp("<", col("r"), E.Param("hi", "int32")))))


def test_shared_tile_route():
    """The shared tile: every column one binding's shape (strided or at
    any offset); a column that differs by binding, or bound conjuncts
    whose columns overflow the tile's shared memory, take the look-back
    scan's binding axis."""
    n = 100
    pred = fu.TileFn(_q12(PE), ["lo", "hi"])
    cols = {k: torch.zeros(n + 1, dtype=torch.int32)[1:]
            for k in ("m", "c", "r", "s")}
    assert kc.shared_tile(cols, pred)
    cols["c"] = torch.zeros((n, 3), dtype=torch.int32)[:, 2]
    assert kc.shared_tile(cols, pred)
    assert not kc.shared_tile(dict(cols, s=torch.zeros((4, n),
                                                       dtype=torch.int32)),
                              pred)
    wide = PE.Cmp("<", PE.Col("x0"), PE.Param("p", "float32"))
    for k in range(1, 14):
        wide = PE.And(wide, PE.Cmp("<", PE.Col(f"x{k}"),
                                   PE.Param("p", "float32")))
    many = {f"x{k}": torch.zeros(n) for k in range(14)}
    assert not kc.shared_tile(many, fu.TileFn(wide, ["p"]))    # 14 x 16 KB
    assert kc.shared_tile({f"x{k}": torch.zeros(n) for k in range(12)},
                          fu.TileFn(_and_all(12), ["p"]))


def _and_all(k: int):
    e = PE.Cmp("<", PE.Col("x0"), PE.Param("p", "float32"))
    for j in range(1, k):
        e = PE.And(e, PE.Cmp("<", PE.Col(f"x{j}"), PE.Param("p", "float32")))
    return e


def test_split_predicate():
    """The top-level conjuncts in order, split by whether they read a
    parameter; an Or is one conjunct; no parameter leaves nothing bound."""
    e = _q12(PE)
    cs = codegen.conjuncts(e)
    assert [type(c).__name__ for c in cs] == ["CodeIn", "Cmp", "Cmp", "Cmp",
                                              "Cmp"]
    free, bound = codegen.split_predicate(e)
    assert free == PE.And(PE.And(cs[0], cs[1]), cs[2])
    assert bound == PE.And(cs[3], cs[4])
    orp = PE.Or(PE.Cmp("<", PE.Col("f"), PE.Param("q", "float32")),
                PE.CodeIn("m", (2,)))
    assert codegen.split_predicate(orp) == (None, orp)
    nop = PE.And(PE.Cmp("<", PE.Col("s"), PE.Col("c")), PE.Const(True))
    assert codegen.split_predicate(nop) == (nop, None)
    assert codegen.reads_param(PE.Where(PE.CodeEq("m", 1), PE.Param(
        "a", "float32"), PE.Const(0.0)))


def test_generated_tile_source():
    """`Tile`: the free conjuncts from device memory, the bound columns
    staged into the tile's copy and read from it with the binding's
    parameters; the shared-tile launcher beside the binding-axis one."""
    e = _q12(PE)
    types = {"m": "int", "c": "int", "r": "int", "s": "int"}
    em = codegen.Emitter(types, {"lo": "int", "hi": "int"})
    src = codegen.compact_pred_batch_source(e, em)
    tile = src[src.index("struct Tile : Src"):]
    tile = tile[:tile.index("\n};")]
    k = {c: list(types).index(c) for c in types}
    assert "static constexpr int kBytes = 4;" in tile
    free = tile[tile.index("free_pred"):tile.index("void stage")]
    for c in ("m", "c", "r", "s"):
        assert f"const int x{k[c]} = c{k[c]}[i];" in free
    assert "p0" not in free and "p1" not in free
    stage = tile[tile.index("void stage"):tile.index("bound_pred")]
    assert stage.count("reinterpret_cast") == 1
    assert f"reinterpret_cast<int*>(tile + 0)[r] = c{k['r']}[i];" in stage
    bound = tile[tile.index("bound_pred"):]
    assert (f"const int x{k['r']} = reinterpret_cast<const int*>(tile + 0)"
            "[r];") in bound
    assert "p0" in bound and "p1" in bound and "c0[" not in bound
    assert "repro::compact_tile_into<Batch, Tile>(bt, B" in src
    assert "repro::compact_batch_into(bt, B" in src
    assert f"static_assert({TILE} == repro::kCompactRows" in src


_HOST_TILE = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "expr.cuh"
namespace {
SRC
}
int main(int argc, char** argv) {
  const long long n = NROWS;
  FILE* f = fopen(argv[1], "rb");
  std::vector<std::vector<char>> bufs(NCOLS);
  std::vector<const void*> cols(NCOLS);
  for (int k = 0; k < NCOLS; ++k) {
    long long bytes;
    if (fread(&bytes, 8, 1, f) != 1) return 2;
    bufs[k].resize(bytes + 16);
    if (fread(bufs[k].data(), 1, bytes, f) != (size_t)bytes) return 2;
    cols[k] = bufs[k].data();
  }
  const double fpv[] = {FPS};
  const long long ipv[] = {IPS};
  std::vector<unsigned char> tile((size_t)Tile::kBytes * TILE + 16);
  long long bad = 0, kept = 0;
  for (int b = 0; b < NB; ++b) {
    const double* fp = fpv + b * NF;
    const long long* ip = ipv + b * NI;
    Tile t{};
    Src& s = t;
FILL
    for (long long base = 0; base < n; base += TILE) {
      for (int r = 0; r < TILE && base + r < n; ++r)
        t.stage(tile.data(), base + r, r);
      for (int r = 0; r < TILE && base + r < n; ++r) {
        const bool want = s.pred(base + r);
        kept += want;
        bad += (t.free_pred(base + r) && t.bound_pred(tile.data(), r)) != want;
      }
    }
  }
  printf("%lld %lld\n", bad, kept);
  return 0;
}
"""


def _special_columns(n: int, seed: int) -> dict:
    """Every column type, with NaN, infinities, subnormals and signed
    zeros among the floats."""
    rng = np.random.default_rng(seed)
    f0 = rng.normal(size=n).astype(np.float32)
    f1 = rng.normal(size=n).astype(np.float32) * 30
    for a in (f0, f1):
        a[rng.integers(0, n, 40)] = np.nan
        a[rng.integers(0, n, 40)] = np.inf
        a[rng.integers(0, n, 40)] = -np.inf
        a[rng.integers(0, n, 40)] = np.float32(1e-40)
        a[rng.integers(0, n, 40)] = -0.0
    return {"b0": rng.random(n) < 0.7, "b1": rng.random(n) < 0.2, "f0": f0,
            "f1": f1, "i0": rng.integers(-50, 50, n).astype(np.int32),
            "m": rng.integers(0, 7, n).astype(np.int32)}


def _typed_pred():
    """Free conjuncts over a float, a bool and a code column; bound ones
    over a float, an int and a bool column, with a float and an int
    parameter (NaN, infinities and a subnormal among the bindings')."""
    col, P = PE.Col, PE.Param
    return PE.And(
        PE.And(PE.Cmp(">=", col("f0"), PE.Const(-0.5)), col("b0")),
        PE.And(PE.CodeIn("m", (0, 2, 5)),
               PE.And(PE.Cmp("<=", col("f1"), P("pf", "float32")),
                      PE.Or(PE.Cmp(">", col("i0"), P("pi", "int32")),
                            col("b1")))))


@pytest.mark.parametrize("which", ["typed", "q12", "or", "free"])
def test_tile_split_matches_row_functor(tmp_path, which):
    """Compiled as host C++ with the kernels' float rules, for every
    binding and row, `free_pred(i) && bound_pred(tile, r)` (the tile
    filled by `stage`) is the row functor's `pred(i)`."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to build the generated source")
    n = 2 * TILE + 77
    cols_np = _special_columns(n, 5)
    cols_np.update(c=np.random.default_rng(6).integers(0, 99, n)
                   .astype(np.int32),
                   r=np.random.default_rng(7).integers(0, 99, n)
                   .astype(np.int32),
                   s=np.random.default_rng(8).integers(0, 99, n)
                   .astype(np.int32))
    if which == "typed":
        pred, params = _typed_pred(), {"pf": "float", "pi": "int"}
        fps = [17.5, float("nan"), float("inf"), -float("inf"), 1e-40, 0.0]
        ips = [0, 10, -60, 60, -1, 3]
    elif which == "q12":
        pred, params = _q12(PE), {"lo": "int", "hi": "int"}
        fps, ips = [], [10, 50, 0, 99, 30, 30, 99, 0]
    elif which == "or":
        pred = PE.Or(PE.Cmp("<", PE.Col("f1"), PE.Param("q", "float32")),
                     PE.CodeIn("m", (2,)))
        params, fps, ips = {"q": "float"}, [0.0, float("nan"), 5.5], []
    else:
        pred = PE.And(PE.Cmp("<", PE.Col("s"), PE.Col("c")), PE.Col("b1"))
        params, fps, ips = {}, [], []
    names = sorted(PE.expr_columns(pred))
    nf = sum(t == "float" for t in params.values())
    ni = len(params) - nf
    nb = max(len(fps) // max(nf, 1), len(ips) // max(ni, 1), 1)
    types = {c: "bool" if c.startswith("b") else "float"
             if c.startswith("f") else "int" for c in names}
    em = codegen.Emitter(types, params)
    src = "\n".join([codegen.functor_source(em, pred),
                     codegen.tile_source(em, pred)])
    lit = (lambda v: "NAN" if v != v else ("INFINITY" if v == float("inf")
           else "-INFINITY" if v == -float("inf") else repr(v)))
    prog = (_HOST_TILE.replace("SRC", src)
            .replace("FILL", "\n".join(em.fill("s")))
            .replace("NROWS", str(n)).replace("NCOLS", str(len(names)))
            .replace("TILE", str(TILE)).replace("NB", str(nb))
            .replace("NF", str(nf)).replace("NI", str(ni))
            .replace("FPS", ", ".join(map(lit, fps)) or "0")
            .replace("IPS", ", ".join(map(str, ips)) or "0"))
    prog = "#include <cmath>\n" + prog
    (tmp_path / "h.cpp").write_text(prog)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-I",
                    str(CSRC), "-o", str(tmp_path / "h"),
                    str(tmp_path / "h.cpp")], check=True, capture_output=True)
    with open(tmp_path / "in.bin", "wb") as fh:
        for c in names:
            b = np.ascontiguousarray(cols_np[c]).tobytes()
            fh.write(np.int64(len(b)).tobytes() + b)
    out = subprocess.run([str(tmp_path / "h"), str(tmp_path / "in.bin")],
                         check=True, capture_output=True, text=True).stdout
    bad, kept = map(int, out.split())
    assert bad == 0
    assert 0 < kept < nb * n


# ---------------------------------------------------------------------------
# a model of the shared-tile scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, TILE - 1, TILE, TILE + 1, 3 * TILE + 5])
@pytest.mark.parametrize("cap,translate", [(1, False), (37, True),
                                           (2 * 32768 + 5, False)])
def test_tile_workspace_words(n, cap, translate):
    """A row's head (status words, ticket, total) is a quad multiple past
    2 x tiles + 2, so idx is 16-byte aligned; the row a quad multiple."""
    tiles = -(-n // TILE)
    head = kc.tile_head(n)
    assert head % 4 == 0 and 2 * tiles + 2 <= head < 2 * tiles + 6
    row = kc.tile_row_words(n, cap, translate)
    extra = cap + (n if translate else 0)
    assert row % 4 == 0 and head + extra <= row < head + extra + 4


def _model_tile_scan(free: np.ndarray, bound: np.ndarray, cap: int,
                     translate: bool, order) -> np.ndarray:
    """Every binding's workspace row as compact_tile_kernel leaves it,
    `free` (n,) the conjuncts that read no parameter and `bound` (B, n)
    each binding's own: the launch's one ticket hands out tiles (blocks
    may finish them in any `order`: each binding's look-back takes the
    sum of its earlier tiles); a tile's free rows are compacted in row
    order (each group's free rows after those of the groups before it),
    a binding's conjuncts ballotted over them 32 at a time, lane l keeping
    free groups 4l .. 4l + 3; each kept id written at its offset, slot_of
    from the compacted ballots; then the pad shares zero idx at or past
    each binding's count.  The rest of a row starts as garbage, the head
    as the memset leaves it."""
    B, n = bound.shape
    tiles, head = -(-n // TILE), kc.tile_head(n)
    ws = np.full((B, kc.tile_row_words(n, cap, translate)), 0x5A5A5A5A,
                 np.int64)
    ws[:, :head] = 0
    pads = -(-cap // kc.BATCH_PAD_WORDS)
    ws[0, 2 * tiles] = tiles + B * pads                   # the ticket
    # each tile's aggregate a binding, as the look-back reads them
    padded = np.zeros((B, max(tiles, 1) * TILE), bool)
    padded[:, :n] = free & bound
    aggs = padded.reshape(B, -1, TILE).sum(2)
    for tile in order:
        base = tile * TILE
        f = np.zeros(TILE, bool)
        f[:min(TILE, n - base)] = free[base:base + TILE]
        fw = f.reshape(128, 32)
        fpre = np.cumsum(fw.sum(1)) - fw.sum(1)           # s_fpre
        rows = np.zeros(TILE, np.int64)                   # s_row
        for g in range(128):
            for l in np.flatnonzero(fw[g]):
                rows[fpre[g] + fw[g, :l].sum()] = 32 * g + l
        nfree = int(f.sum())
        ngroups = -(-nfree // 32)
        for b in range(B):
            m = np.zeros(128 * 32, bool)
            for p in range(nfree):
                m[p] = bound[b, base + rows[p]]
            bal = m.reshape(128, 32)
            bal[ngroups:] = False
            counts = bal.sum(1).reshape(32, 4)            # lane l: 4 groups
            lane_excl = np.cumsum(counts.sum(1)) - counts.sum(1)
            assert aggs[b, tile] == counts.sum()
            excl = int(aggs[b, :tile].sum())
            off = np.array([excl + lane_excl[c // 4] + counts[c // 4, :c % 4]
                            .sum() for c in range(128)])
            for c in range(ngroups):
                for l in range(32):
                    pos = off[c] + bal[c, :l].sum()
                    if bal[c, l] and pos < cap:
                        ws[b, head + pos] = base + rows[32 * c + l]
            if translate:
                for r in range(min(TILE, n - base)):
                    g, l = divmod(r, 32)
                    v = -1
                    if fw[g, l]:
                        p = fpre[g] + fw[g, :l].sum()
                        c, k = divmod(p, 32)
                        if bal[c, k]:
                            v = off[c] + bal[c, :k].sum()
                    ws[b, head + cap + base + r] = v
            if tile == tiles - 1:
                ws[b, head - 1] = excl + aggs[b, tile]
    for share in range(B * pads):
        b, part = divmod(share, pads)
        count = int(aggs[b].sum())
        lo = max(part * kc.BATCH_PAD_WORDS, count)
        hi = min((part + 1) * kc.BATCH_PAD_WORDS, cap)
        ws[b, head + lo:head + max(lo, hi)] = 0
    return ws


@pytest.mark.parametrize("n,cap,translate", [
    (TILE - 1, 900, True), (TILE, 100, False), (TILE + 1, 2 * 32768 + 5, True),
    (3 * TILE + 7, 5000, False), (40, 64, True)])
def test_tile_scan_model_matches_plain(n, cap, translate):
    """The model of the tiles (in any order), the compacted free rows, the
    per-binding look-back, the lanes' groups and the pad shares holds the
    plain version's packed output (count, ids, pad zeros, slot_of) in
    every binding's row, for free rows at densities from none to all."""
    B = 5
    rng = np.random.default_rng(n + cap)
    free = rng.random(n) < 0.3
    free[: n // 7] = False
    free[n // 7: 2 * n // 7] = True
    bound = rng.random((B, n)) < np.array([0.0, 0.01, 0.3, 0.9, 1.0])[:, None]
    tiles = -(-n // TILE)
    ws = _model_tile_scan(free, bound, cap, translate, rng.permutation(tiles))
    head = kc.tile_head(n)
    packed = kc._packed_view(torch.from_numpy(ws), n, cap, translate, head)
    want = kc.pack(kc.compact_batched_plain(T(free & bound), cap, translate))
    np.testing.assert_array_equal(packed.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# the plain batched versions against the vmapped Pallas kernels
# ---------------------------------------------------------------------------

def _q12_case(B: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    c = rng.integers(8000, 10600, n).astype(np.int32)
    cols = {"m": rng.integers(0, 7, n).astype(np.int32), "c": c,
            "r": c + rng.integers(-30, 60, n).astype(np.int32),
            "s": rng.integers(8000, 10600, n).astype(np.int32)}
    lo = rng.integers(8000, 10400, B)
    lo[0] = 20000                                 # binding 0: no row
    hi = lo + rng.integers(0, 400, B)
    if B > 1:
        lo[1], hi[1] = 0, 30000                   # binding 1: the free rows
    return cols, [lo.astype(np.int32), hi.astype(np.int32)]


@pytest.mark.parametrize("translate", [False, True])
@pytest.mark.parametrize("B", BINDINGS)
@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 3 * TILE + 17])
def test_compact_pred_batched_plain_at_tile_boundaries(n, B, translate):
    """q12's shape, every column shared (the shared-tile pattern), the
    date window batched; the capacity a fortieth of n, so the widest
    bindings overflow it."""
    cap = n // 40
    cols, params = _q12_case(B, n, seed=n + B)
    tcols = {k: T(v) for k, v in cols.items()}
    pred = fu.TileFn(_q12(PE), ["lo", "hi"])
    assert kc.shared_tile(tcols, pred)
    fp, ip, kinds = kc.param_vectors([torch.from_numpy(p) for p in params])
    got = kc.compact_pred_batched(tcols, fp, ip, kinds, pred, cap,
                                  translate=translate)
    want = jax.vmap(
        lambda c, s: ref_ops.compact_pred(
            c, s, ref_fused.make_tile_fn(_q12(RE), ["lo", "hi"]), cap,
            translate=translate, interpret=True),
        in_axes=({k: None for k in cols}, [0, 0]))(
        {k: jnp.asarray(v) for k, v in cols.items()},
        [jnp.asarray(p) for p in params])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][0]) == 0
    if B > 1:
        assert int(got[1][1]) > cap          # past the capacity


@pytest.mark.parametrize("B", BINDINGS)
@pytest.mark.parametrize("n", [SLICE - 1, SLICE, SLICE + 1, 8 * SLICE + 1,
                               10_001])
@pytest.mark.parametrize("G,A", [(1, 2), (3, 1)])
def test_filter_agg_batched_plain_at_slice_boundaries(n, B, G, A):
    """q14's pattern (a batched mask, a shared group index and shared
    value columns: the staged pattern) around a warp's slice of 128 rows
    and a block's step, out-of-range group indexes among them."""
    rng = np.random.default_rng(n + B + G)
    mask = rng.random((B, n)) < np.linspace(0.0, 1.0, B)[:, None]
    gidx = rng.integers(-1, G + 1, n).astype(np.int32)
    vals = [rng.normal(size=n).astype(np.float32) for _ in range(A)]
    tm, tg, tv = T(mask), T(gidx), [T(v) for v in vals]
    assert kf.staged_operands(tm, tg, tv, G) == (tg.data_ptr() % 16 == 0
                                                and all(v.data_ptr() % 16 == 0
                                                        for v in tv))
    got = kf.filter_agg_batched(tm, tg, tv, G)
    want = jax.vmap(
        lambda m, g, v: ref_ops.filter_agg_query(m, g, v, G, interpret=True),
        in_axes=(0, None, [None] * A))(
        jnp.asarray(mask), jnp.asarray(gidx), [jnp.asarray(v) for v in vals])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
