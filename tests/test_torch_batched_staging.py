"""The two redesigned batched kernels' CPU side: what the wrappers decide
in Python, what the generators emit, and the plain batched versions at
the new tiles' and slices' boundaries.

  * `compact_batched`'s wide-tile scan: its tile, workspace words and pad
    blocks (mirrored from `csrc/compact.cuh`), and a numpy model of the
    kernel (byte_bits, the 16-byte and shifted loads, the thread ranks,
    each warp's 32-row groups, the pad blocks' zeros) whose workspace row
    must hold the plain version's packed output;
  * `selective_filter_agg_batched`'s staging: the cluster size and the
    bindings' padding, which columns are staged (shared and contiguous,
    against batched, strided and unaligned), the generated `Stage`'s text
    (staged columns from the stage's registers, the others from device
    memory) and, compiled as host C++, its quad methods bit for bit the
    row functor's on NaN, infinities and every staged type;
  * the plain batched versions against `jax.vmap` of the reference's
    Pallas kernels in interpret mode at n = tile - 1, tile and tile + 1 (a
    warp's slice of 128 rows and a block's step of 1,024 for the
    aggregation), B = 1, 7, 9 and 64, with translate and past the
    capacity.

The card's own checks of the two kernels are in
`test_torch_batched_staging_cuda.py`.  Tolerances: integer outputs
exact; float sums rtol 1e-5, atol 1e-4 (as `test_torch_kernels`).
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
from test_torch_kernels import (ATOL, RTOL, T, _columns, _pnames, _preds,
                                _values)

kc = importlib.import_module("repro_torch.kernels.compact")
kf = importlib.import_module("repro_torch.kernels.filter_agg")

TILE = kc.BATCH_TILE_ROWS
SLICE = codegen.SLICE_ROWS


def _constant(header: str, name: str) -> int:
    """An integer `constexpr` of a csrc header, as written there (a
    literal, a product of literals and earlier constants, or `a * 1024`)."""
    text = (CSRC / header).read_text()
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);", text)
    assert m, name
    expr = m.group(1)
    for dep in set(re.findall(r"\bk[A-Za-z]+\b", expr)):
        for h in ("compact.cuh", "filter_agg.cuh", "agg_regs.cuh",
                  "common.cuh"):
            if re.search(rf"constexpr (?:int|size_t) {dep} =",
                         (CSRC / h).read_text()):
                expr = re.sub(rf"\b{dep}\b", str(_constant(h, dep)), expr)
                break
    return int(eval(expr, {}))


def test_python_mirrors_the_headers():
    """The wrappers' copies of the kernels' constants."""
    assert TILE == _constant("compact.cuh", "kBatchTileRows") == 16384
    assert kc.BATCH_PAD_WORDS == _constant("compact.cuh", "kBatchPadWords")
    assert SLICE == _constant("filter_agg.cuh", "kStageRows") == 128
    C = kf.CLUSTER_MAX      # at most the portable size, a power of two
    assert C <= _constant("filter_agg.cuh", "kAggMaxCluster") and not C & C - 1
    assert kf.STAGE_BYTES_MAX == \
        _constant("filter_agg.cuh", "kStageBudget") // 2
    assert kf.STEPS_PER_SLOT == _constant("filter_agg.cuh", "kStepsPerSlot")
    assert (kf.REG_MAX_GROUPS, kf.REG_MAX_VALS,
            kf.REG_MAX_VALS_ONE_GROUP) == tuple(
        _constant("agg_regs.cuh", k) for k in
        ("kRegMaxGroups", "kRegMaxVals", "kRegMaxValsOneGroup"))


# ---------------------------------------------------------------------------
# compact_batched: tile, workspace, and a model of the kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, TILE - 1, TILE, TILE + 1, 5 * TILE])
@pytest.mark.parametrize("cap,translate", [(1, False), (37, True),
                                           (2 * 32768 + 5, False)])
def test_batched_workspace_words(n, cap, translate):
    """A row's head (status words, ticket, total) is a quad multiple past
    2 x tiles + 2, so idx is 16-byte aligned; the row a quad multiple."""
    tiles = -(-n // TILE)
    assert kc.batched_tiles(n) == tiles
    head = kc.batched_head(n)
    assert head % 4 == 0 and 2 * tiles + 2 <= head < 2 * tiles + 6
    row = kc.batched_row_words(n, cap, translate)
    assert row % 4 == 0
    assert head + cap + (n if translate else 0) <= row < \
        head + cap + (n if translate else 0) + 4


def _byte_bits(w):
    """csrc/compact.cuh's byte_bits on uint32 words, as written there."""
    w = w.astype(np.uint64)
    hi = (((w & 0x7F7F7F7F) + 0x7F7F7F7F) | w) & 0x80808080
    return (((hi >> 7) * 0x01020408) & 0xFFFFFFFF) >> 24


def _quad_bits(b16: np.ndarray) -> int:
    w = b16.view("<u4")
    bits = _byte_bits(w)
    return int(bits[0] | bits[1] << 4 | bits[2] << 8 | bits[3] << 12)


def _mask_bits32(mem: np.ndarray, addr: int, r0: int, n: int) -> int:
    """mask_bits32 over a byte memory `mem` holding the mask at `addr`."""
    a = addr + r0
    if r0 + 32 <= n:
        s = a % 16
        if s == 0:
            return _quad_bits(mem[a:a + 16]) | _quad_bits(mem[a + 16:a + 32]) \
                << 16
        lo = a - s
        bits = (_quad_bits(mem[lo:lo + 16])
                | _quad_bits(mem[lo + 16:lo + 32]) << 16
                | _quad_bits(mem[lo + 32:lo + 48]) << 32)
        return (bits >> s) & 0xFFFFFFFF
    return sum(1 << j for j in range(32) if r0 + j < n and mem[a + j])


def test_byte_bits():
    """Bit r of byte_bits(w) is byte r of w nonzero, for any byte value."""
    rng = np.random.default_rng(0)
    b = rng.integers(0, 256, (4096, 4)).astype(np.uint8)
    b[rng.random((4096, 4)) < 0.5] = 0
    got = _byte_bits(b.view("<u4")[:, 0])
    want = sum((b[:, r] != 0).astype(np.uint64) << r for r in range(4))
    np.testing.assert_array_equal(got, want)


def _model_compact_batched(mask_bytes: np.ndarray, addr: int, n: int,
                           cap: int, translate: bool) -> np.ndarray:
    """One binding's workspace row as compact_batched_kernel leaves it:
    the mask read from byte memory at `addr` (its alignment chooses the
    loads), tiles in ticket order, warps' 32-row groups written in row
    order, pad blocks zeroing [count, cap); the rest of the row starts
    as garbage, the head as the memset leaves it."""
    mem = np.zeros(addr + n + 64, np.uint8)
    mem[addr:addr + n] = mask_bytes
    tiles, head = kc.batched_tiles(n), kc.batched_head(n)
    ws = np.full(kc.batched_row_words(n, cap, translate), 0x5A5A5A5A,
                 np.int64)
    ws[:head] = 0
    idx = ws[head:head + cap]
    slot = ws[head + cap:head + cap + n]
    prefix = 0
    for tile in range(tiles):
        base = tile * TILE
        bits = np.array([[_mask_bits32(mem, addr, base + w * 1024 + 32 * l, n)
                          for l in range(32)] for w in range(16)], np.int64)
        c = np.array([[bin(int(x)).count("1") for x in row] for row in bits])
        e = prefix + np.cumsum(c.ravel()).reshape(16, 32) - c
        for w in range(16):
            wrow = base + w * 1024
            for r in range(32):
                mr = int(bits[w, r])
                for lane in range(32):
                    if mr >> lane & 1:
                        p = int(e[w, r]) + bin(mr & ((1 << lane) - 1)
                                               ).count("1")
                        if p < cap:
                            idx[p] = wrow + 32 * r + lane
            if translate:
                for lane in range(32):
                    p, r0 = int(e[w, lane]), wrow + 32 * lane
                    for j in range(32):
                        if r0 + j < n:
                            slot[r0 + j] = p if bits[w, lane] >> j & 1 \
                                else -1
                            p += int(bits[w, lane] >> j & 1)
        prefix += int(c.sum())
    ws[head - 1] = prefix
    for pad in range(-(-cap // kc.BATCH_PAD_WORDS)):
        lo = max(pad * kc.BATCH_PAD_WORDS, prefix)
        hi = min((pad + 1) * kc.BATCH_PAD_WORDS, cap)
        idx[lo:max(lo, hi)] = 0
    return ws


@pytest.mark.parametrize("addr", [0, 1, 7, 15])
@pytest.mark.parametrize("n,p,cap,translate", [
    (TILE - 1, 0.5, 9000, True), (TILE, 1.0, 100, False),
    (TILE + 1, 0.003, 2 * 32768 + 5, True), (3 * TILE + 1, 0.3, 20000, False),
    (40, 0.5, 64, True)])
def test_kernel_model_matches_plain(addr, n, p, cap, translate):
    """The model of the kernel's loads, ranks, group stores, slot_of and
    pad zeros holds the plain version's packed output (count, ids, pad
    zeros, slot_of) at every alignment of the binding's first row."""
    rng = np.random.default_rng(n + addr)
    mask = rng.random(n) < p
    raw = mask.astype(np.uint8) * rng.integers(1, 256, n).astype(np.uint8)
    ws = _model_compact_batched(raw, addr, n, cap, translate)
    head = kc.batched_head(n)
    got = ws[head - 1:head + cap + (n if translate else 0)]
    want = kc.pack(kc.compact_plain(T(mask), cap, translate)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# selective_filter_agg_batched: clusters and staging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,warps,C,padded", [
    (1, 8, 1, 8), (3, 8, 1, 8), (7, 8, 1, 8), (8, 8, 1, 8), (9, 16, 1, 16),
    (17, 16, 2, 32), (64, 16, 2, 64), (65, 16, 2, 96)])
def test_cluster_shape(B, warps, C, padded):
    """A warp a binding, 8 or 16 to a block; blocks to a cluster the
    least power of two that holds B bindings, up to CLUSTER_MAX (2); B
    padded to whole groups of a cluster's bindings."""
    assert kf.staged_warps(B) == warps
    assert kf.cluster_shape(B) == (C, padded)


def test_staged_columns():
    """Staged: shared, contiguous, 16-byte aligned, in the register
    regime, while a stage fits; not: batched, a record matrix's column,
    a view one element in, anything in the shared-memory regime."""
    n = 5000
    col = torch.zeros(n + 4, dtype=torch.int32)
    rec = torch.zeros((n, 3))
    cols = {"shared": col[:n], "batched": torch.zeros((4, n)),
            "strided": rec[:, 1], "unaligned": col[1:n + 1],
            "flag": torch.zeros(n, dtype=torch.bool),
            "aligned4": col[4:n + 4]}
    assert cols["strided"].stride(0) == 3
    assert kf.staged_columns(cols, 6, 7) == ("shared", "flag", "aligned4")
    assert kf.staged_columns(cols, 1, 16) == ("shared", "flag", "aligned4")
    assert kf.staged_columns(cols, 9, 2) == ()      # shared-memory regime
    assert kf.staged_columns(cols, 1, 17) == ()
    # a ring slot holds STAGE_BYTES_MAX: 8 steps of the first 16 4-byte
    # columns
    many = {f"c{k}": torch.zeros(n) for k in range(20)}
    assert kf.staged_columns(many, 1, 1) == tuple(f"c{k}" for k in range(16))


def _stage_case():
    """q1-like operands: every staged type (int, float, bool), one column
    left in device memory, parameters, groups and values."""
    pe = PE.And(_preds(PE)["params"], PE.Not(PE.Col("b0")))
    values = _values(PE)
    radix = [("c0", 7, 3), ("k0", 3, 1)]
    names = set(PE.expr_columns(pe)) | {"c0", "k0"}
    for e in values:
        names |= PE.expr_columns(e)
    pnames = _pnames(pe)
    return pe, values, radix, sorted(names), pnames


def _types(names):
    return {c: "bool" if c == "b0" else "float" if c.startswith("f")
            else "int" for c in names}


def test_generated_stage_source():
    """Staged columns are read from the quad's registers, loaded from the
    stage by one vector load each at their offsets; the others from
    device memory; the launcher takes the cluster size."""
    pe, values, radix, names, pnames = _stage_case()
    em = codegen.Emitter(_types(names), {"pf": "float", "pi": "int"})
    staged = ("b0", "c0", "f0", "k0")           # f1 and i0 unstaged
    src = codegen.selective_agg_batch_source(pe, values, radix, 21, em,
                                             staged)
    stage = src[src.index("struct Stage : Src"):]
    stage = stage[:stage.index("\n};")]
    k = {c: names.index(c) for c in names}
    assert "static constexpr int kCols = 4;" in stage
    assert f"static constexpr int kBytes = {13 * SLICE};" in stage
    assert f"uchar4 w = reinterpret_cast<const uchar4*>(stage + 0)" in stage
    assert f"int4 w = reinterpret_cast<const int4*>(stage + {SLICE})" in stage
    q_methods = stage[stage.index("pred_q"):]
    for c in staged:
        assert f"x{k[c]} = q{k[c]}[r];" in q_methods
        assert f"c{k[c]}[i]" not in q_methods
    for c in ("f1", "i0"):
        assert f"q{k[c]}[" not in stage
        assert f"x{k[c]} = c{k[c]}[i];" in q_methods
    assert "int C, long long n" in src and "launch_agg_staged<Batch, Stage" \
        in src and "repro_selective_agg_batched_info" in src
    # nothing staged: the same methods, every column from device memory
    em.used.clear()
    none = codegen.stage_source(em, pe, values, radix, 21, ())
    assert "kCols = 0" in none and "q0[" not in none


_HOST_STAGE = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "expr.cuh"
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
struct uchar4 { unsigned char x, y, z, w; };
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
  const double fpv[1] = {FP};
  const long long ipv[1] = {IP};
  const double* fp = fpv; const long long* ip = ipv;
  Stage st{};
  Src& s = st;
FILL
  std::vector<unsigned char> stage(Stage::kBytes + 16);
  long long bad = 0;
  for (long long base = 0; base + SLICE <= n; base += SLICE) {
    st.each([&](const unsigned char* col, int size, int off) {
      memcpy(stage.data() + off, col + base * size, size * SLICE);
    });
    for (int quad = 0; quad < SLICE / 4; ++quad) {
      st.load(stage.data(), quad);
      for (int r = 0; r < 4; ++r) {
        const long long i = base + 4 * quad + r;
        float v[NV], w[NV];
        s.values(i, v);
        st.values_q(i, r, w);
        bad += s.pred(i) != st.pred_q(i, r);
        bad += s.group(i) != st.group_q(i, r);
        bad += memcmp(v, w, sizeof v) != 0;
      }
    }
  }
  printf("%lld\n", bad);
  return 0;
}
"""


@pytest.mark.parametrize("staged", [("b0", "c0", "f0", "k0"),
                                    ("f1", "i0", "i1", "d0"), ()])
def test_stage_methods_match_row_functor(tmp_path, staged):
    """Compiled as host C++ with the kernels' float rules, the Stage's
    quad methods (staged columns from a stage filled by `each`, read by
    `load`) give the row functor's predicate, group and value bits on
    every row of every whole slice, NaN and infinities among them."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to build the generated source")
    pe, values, radix, names, pnames = _stage_case()
    names = sorted(set(names) | {"d0"})
    n = 3 * SLICE + 5
    cols_np = _columns(n, seed=3)
    cols_np["b0"] = np.random.default_rng(4).random(n) < 0.3
    cols_np["f0"][7], cols_np["f1"][9], cols_np["f0"][11] = \
        np.nan, np.inf, -np.inf
    em = codegen.Emitter(_types(names), {"pf": "float", "pi": "int"})
    src = "\n".join([codegen.functor_source(em, pe, values, radix, 21),
                     codegen.stage_source(em, pe, values, radix, 21,
                                          staged)])
    prog = (_HOST_STAGE.replace("SRC", src)
            .replace("FILL", "\n".join(em.fill("s")))
            .replace("NROWS", str(n)).replace("NCOLS", str(len(names)))
            .replace("NV", str(len(values))).replace("SLICE", str(SLICE))
            .replace("FP", "17.5").replace("IP", "40"))
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
    assert out.strip() == "0"


# ---------------------------------------------------------------------------
# the plain batched versions against the vmapped Pallas kernels
# ---------------------------------------------------------------------------

def _masks(B: int, n: int, seed: int) -> np.ndarray:
    """B masks: binding 0 empty, binding 1 full (past the capacity), the
    rest about 30 %."""
    rng = np.random.default_rng(seed)
    m = rng.random((B, n)) < 0.3
    m[0] = False
    if B > 1:
        m[1] = True
    return m


@pytest.mark.parametrize("translate", [False, True])
@pytest.mark.parametrize("B", [1, 7, 9, 64])
@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1])
def test_compact_batched_plain_at_tile_boundaries(n, B, translate):
    """n around one wide tile; the capacity a third of n, so the full
    binding and most 30 % ones overflow it."""
    cap = n // 3
    mask = _masks(B, n, seed=n + B)
    got = kc.compact_batched(T(mask), cap, translate=translate)
    want = jax.vmap(lambda m: ref_ops.compact(m, cap, interpret=True,
                                              translate=translate))(
        jnp.asarray(mask))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1].numpy(), mask.sum(1))


@pytest.mark.parametrize("B", [1, 7, 9, 64])
@pytest.mark.parametrize("n", [SLICE - 1, SLICE, SLICE + 1, 8 * SLICE - 1,
                               8 * SLICE + 1])
def test_selective_batched_plain_at_slice_boundaries(n, B):
    """Shared columns (the staged pattern), batched parameters, 7 groups
    (the register regime), around a warp's slice of 128 rows and a
    block's step of 1,024."""
    pe, re_ = _preds(PE)["params"], _preds(RE)["params"]
    pv, rv = _values(PE), _values(RE)
    radix = [("c0", 7, 1)]
    names = set(PE.expr_columns(pe)) | {"c0"}
    for e in pv:
        names |= PE.expr_columns(e)
    names = sorted(names)
    pnames = _pnames(pe)
    cols = _columns(n, 11 + B)
    rng = np.random.default_rng(n + B)
    params = [(rng.integers(5, 45, B) + 0.5).astype(np.float32),
              rng.integers(10, 90, B).astype(np.int32)]
    fp, ip, kinds = kc.param_vectors([torch.from_numpy(p) for p in params])
    tcols = {k: T(cols[k]) for k in names}
    assert kf.staged_columns(tcols, 7, len(pv)) == tuple(names)
    gfn = fu.GroupIndex(radix, 7)
    got = kf.selective_filter_agg_batched(
        tcols, fp, ip, kinds, fu.TileFn(pe, pnames),
        [fu.TileFn(e, pnames) for e in pv], gfn, 7)

    def jgidx(c, _s):
        return jnp.clip(c["c0"].astype(jnp.int32), 0, 6)

    want = jax.vmap(
        lambda c, s: ref_ops.selective_agg_query(
            c, s, ref_fused.make_tile_fn(re_, pnames),
            [ref_fused.make_tile_fn(e, pnames) for e in rv], jgidx, 7,
            interpret=True),
        in_axes=({k: None for k in names}, [0, 0]))(
        {k: jnp.asarray(cols[k]) for k in names},
        [jnp.asarray(p) for p in params])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
