"""Dense aggregation over a large key domain on the card
(`kernels/dense_agg.py`, `csrc/dense_agg.cu`): the kernel against the
engine's PyTorch segment operations it replaces, its batched form under
vmap, and the plans that take it (q3, q7, q10, q13, q17, q18 at TPC-H SF 1,
seed 0) replayed, batched and run from four threads under the profiler.

Run on a machine with an NVIDIA card and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_dense_agg_cuda.py

Without CUDA every test here skips (the decision is taken inside the
`cuda` fixture, never at import).  This file does not import JAX.  On
every present group the counts and carries must be exact and the sums
within 1e-5 of a float64 sum, relative to the sum of its terms'
magnitudes (float32 rounding's scale: a sum of 350,000 terms of both
signs that cancels down to -387 rounds about 0.007 off in any order;
the kernel adds with atomics in no fixed order); a group no kept row
reaches is absent in both, its count 0.  Query answers are held to the eager walk as
`test_torch_graph_cuda.py` holds them: floats within 1e-4, the rest
equal, rows as a set.
"""
import importlib
import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, preset
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.kernels import ops
from repro_torch.relational import Database
from repro_torch.relational.queries import PARAM_QUERIES, QUERIES

pytestmark = pytest.mark.cuda

kd = importlib.import_module("repro_torch.kernels.dense_agg")

# the plans with a dense aggregation past filter_agg's domains at SF 1
# (q7's nation x nation x year is 5,000 groups)
LARGE = ["q10", "q13", "q17", "q18", "q3", "q7"]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def db(cuda):
    return Database.tpch(sf=1.0, seed=0)


# ---------------------------------------------------------------------------
# the kernel against the segment operations
# ---------------------------------------------------------------------------

def _keys(case: str, n: int, D: int, rng) -> np.ndarray:
    if case == "clustered":     # runs of 1 to 7, as lineitem by l_orderkey
        runs = rng.integers(1, 8, size=n)
        keys = np.repeat(np.arange(n) % D, runs)[:n]
    elif case == "edges":       # the domain's first and last keys
        keys = np.where(rng.random(n) < 0.5, 0, D - 1)
    else:                       # shuffled
        keys = rng.integers(0, D, size=n)
    return keys.astype(np.int32)


def _case(case: str, n: int, D: int, seed: int, p: float = 0.7):
    """(mask, gidx, values, carries) on the CPU as numpy arrays."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < p
    if case == "all_masked":
        mask[:] = False
    gidx = _keys(case, n, D, rng)
    values = [rng.uniform(0.5, 2.0, n).astype(np.float32),
              rng.uniform(-3.0, 3.0, n).astype(np.float32)]
    carries = [(rng.normal(size=n) * 1000).astype(np.float32),    # < 0 too
               rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)]
    return mask, gidx, values, carries


def _expect(mask, gidx, values, carries, D):
    """float64 sums, counts and the carries' max of the present groups,
    and each sum's scale: the float64 sum of its terms' magnitudes."""
    g, m = gidx[mask], mask.sum()
    counts = np.bincount(g, minlength=D)
    sums = [np.bincount(g, weights=v[mask].astype(np.float64), minlength=D)
            for v in values]
    scales = [np.bincount(g, weights=np.abs(v[mask].astype(np.float64)),
                          minlength=D) for v in values]
    carried = []
    for c in carries:
        out = np.full(D, np.iinfo(np.int64).min, dtype=np.int64) \
            if c.dtype == np.int32 else np.full(D, -np.inf)
        np.maximum.at(out, g, c[mask].astype(out.dtype))
        carried.append(out)
    assert m == counts.sum()
    return sums, counts, carried, scales


def _check(got, want):
    sums, counts, carried = [_np(x) for x in got[0]], _np(got[1]), \
        [_np(x) for x in got[2]]
    wsums, wcounts, wcarried, scales = want
    assert np.array_equal(counts, wcounts)
    present = wcounts > 0
    for s, w, scale in zip(sums, wsums, scales):
        gap = np.abs(s.astype(np.float64) - w)[present]
        assert (gap <= 1e-5 * scale[present] + 1e-6).all(), gap.max()
        assert not s[~present].any()
    for c, w in zip(carried, wcarried):
        assert np.array_equal(c[present].astype(w.dtype), w[present])
        assert not c[~present].any()


def _np(t):
    return t.detach().cpu().numpy()


def _dev(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.parametrize("case", ["clustered", "shuffled", "edges",
                                  "all_masked"])
@pytest.mark.parametrize("n", [1, 37, 4099, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_matches_the_segment_ops(cuda, case, n, offset):
    """Every present group's sums, count and carries; runs crossing warp,
    chunk and block boundaries; a mask at an odd address (byte loads)."""
    D = 150_000
    mask, gidx, values, carries = _case(case, n + offset, D, n)
    cut = slice(offset, None)
    m, g, *cols = _dev([mask, gidx, *values, *carries], cuda)
    m, g, cols = m[cut], g[cut], [c[cut] for c in cols]
    before = kd.launches["dense_agg"]
    got = kd.dense_agg(m, g, cols[:2], cols[2:], D)
    torch.cuda.synchronize()
    assert kd.launches["dense_agg"] == before + 1
    want = _expect(mask[cut], gidx[cut], [v[cut] for v in values],
                   [c[cut] for c in carries], D)
    _check(got, want)
    # the segment operations agree on the counts and on every present
    # group's carry at or above -1: they fill a dropped row's int carry
    # with -1, which stands above a kept row's below it
    plain = kd.dense_agg_plain(m, g, cols[:2], cols[2:], D)
    assert np.array_equal(_np(plain[1]), _np(got[1]))
    for a, b, w in zip(plain[2], got[2], want[2]):
        same = (want[1] > 0) & (w >= -1)
        assert np.array_equal(_np(a)[same], _np(b)[same])
    assert got[2][0].dtype == torch.float32
    assert got[2][1].dtype == torch.int32


def test_zero_rows_and_no_columns(cuda):
    """No row: every group absent.  No value and no carry: counts only."""
    D = 5000
    m = torch.zeros(0, dtype=torch.bool, device=cuda)
    g = torch.zeros(0, dtype=torch.int32, device=cuda)
    v = torch.zeros(0, dtype=torch.float32, device=cuda)
    sums, counts, carried = kd.dense_agg(m, g, [v], [v], D)
    assert not counts.any() and not sums[0].any() and not carried[0].any()
    mask, gidx, _v, _c = _case("clustered", 70_001, D, 3)
    m, g = _dev([mask, gidx], cuda)
    sums, counts, carried = kd.dense_agg(m, g, [], [], D)
    assert sums == [] and carried == []
    assert np.array_equal(_np(counts), np.bincount(gidx[mask], minlength=D))


# ---------------------------------------------------------------------------
# the batched form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 2, 64])
@pytest.mark.parametrize("shared", ["none", "keys", "mask"])
def test_vmap_matches_each_binding(cuda, B, shared):
    """`ops.dense_agg_query` under `torch.func.vmap`: one launch for B
    bindings, with shared (unbatched) operands read at stride 0, each
    slot the scalar kernel's answer on its binding's operands."""
    n, D = 300_007, 120_000
    per = [_case("clustered" if b % 2 else "shuffled", n, D, 100 + b)
           for b in range(B)]
    mask = np.stack([p[0] for p in per])
    gidx = np.stack([p[1] for p in per])
    vals = np.stack([p[2][0] for p in per])
    cars = np.stack([p[3][0] for p in per])
    icar = np.stack([p[3][1] for p in per])
    if shared == "keys":
        gidx[:] = gidx[0]
        vals[:] = vals[0]
    if shared == "mask":
        mask[:] = mask[0]
    m, g, v, c, i = _dev([mask, gidx, vals, cars, icar], cuda)
    dims = (None if shared == "mask" else 0,
            None if shared == "keys" else 0,
            None if shared == "keys" else 0, 0, 0)
    args = [t if d == 0 else t[0] for t, d in zip((m, g, v, c, i), dims)]

    def one(m_, g_, v_, c_, i_):
        return ops.dense_agg_query(m_, g_, [v_], [c_, i_], D)

    launched = kd.launches["dense_agg_batched"]
    calls = ops.calls["dense_agg"]
    sums, counts, carried = torch.func.vmap(one, in_dims=dims)(*args)
    torch.cuda.synchronize()
    assert kd.launches["dense_agg_batched"] == launched + 1
    assert ops.calls["dense_agg"] == calls + 1
    assert counts.shape == (B, D) and sums[0].shape == (B, D)
    for b in range(B):
        want = _expect(mask[b], gidx[b], [vals[b]], [cars[b], icar[b]], D)
        _check(([sums[0][b]], counts[b], [carried[0][b], carried[1][b]]),
               want)


def test_batched_offsets_pass_two_to_the_31_words(cuda):
    """64 result rows of 4,000,000 groups x 9 columns: 2.3e9 words, past
    what a 32-bit offset reaches; the last binding's groups are right."""
    B, n, D = 64, 200_003, 4_000_000
    rng = np.random.default_rng(7)
    mask = rng.random((B, n)) < 0.5
    gidx = rng.integers(D - 300_000, D, size=n).astype(np.int32)
    vals = [rng.uniform(0.5, 2.0, n).astype(np.float32) for _ in range(4)]
    cars = [rng.integers(-1000, 1000, n).astype(np.int32) for _ in range(4)]
    m, g, *cols = _dev([mask, gidx, *vals, *cars], cuda)
    rows = kd.dense_agg_batched_packed(m, g, cols[:4], cols[4:], D)
    assert rows.shape == (B, 9 * D)
    got = kd.unpack(rows[B - 1], D, 4, "iiii")
    torch.cuda.synchronize()
    _check(got, _expect(mask[B - 1], gidx, vals, cars, D))
    del rows, got
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def _eager(cq, params=None) -> dict:
    run = cq.execute(cq.bind(params))
    return cq._settle([params], [run])[0]


def _same(got: dict, want: dict):
    assert list(got) == list(want)
    rows = [sorted(zip(*[r[k].tolist() for k in r]), key=repr)
            for r in (got, want)]
    assert len(rows[0]) == len(rows[1])
    for g, w in zip(*rows):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-4, abs=1e-5)
            else:
                assert x == y


def _param_query(db, qname):
    build, defaults = PARAM_QUERIES[qname]
    plan = build()
    spec = plan_params(plan)
    runtime = {k: defaults[k] for k, i in spec.items() if not i.structural}
    plan = bind_plan(plan, {k: defaults[k] for k, i in spec.items()
                            if i.structural})
    return CompiledQuery(plan, db, preset("opt-pallas"),
                         params=runtime), runtime


def test_the_plans_that_take_the_kernel(db):
    """At SF 1 the large-domain kernel serves q3, q7, q10, q13, q17 and
    q18, once in an eager walk of each (`chip_smoke.DENSE_AGG_SF1`, which
    the smoke's main path holds the launches to), and no other of the 15
    plans; each graph keeps its segments (one more than the plan's calls
    of the four cut entry points, which are its launches in
    `chip_smoke.LAUNCHES_SF1`)."""
    cs = _chip_smoke()
    engaged = {}
    for q in sorted(QUERIES):
        cq = CompiledQuery(QUERIES[q](), db, preset("opt-pallas"))
        before = kd.launches["dense_agg"]
        cq.run()                        # uncompiled: an eager walk
        if kd.launches["dense_agg"] > before:
            engaged[q] = kd.launches["dense_agg"] - before
        cq.compile()
        assert cq.graph_segments == 1 + sum(cs.LAUNCHES_SF1[q].values()), \
            (q, cq.capture_error)
    assert engaged == cs.DENSE_AGG_SF1
    assert sorted(engaged) == sorted(LARGE)


@pytest.mark.parametrize("qname", LARGE)
def test_replayed_plan_gives_the_eager_answer(db, qname):
    """The kernel captured inside a segment: a replay launches it without
    calling the entry point, and answers as the eager walk does."""
    cq = CompiledQuery(QUERIES[qname](), db, preset("opt-pallas"))
    cq.compile()
    assert cq.graph_segments >= 1, cq.capture_error
    want = _eager(cq)
    calls = ops.calls["dense_agg"]
    for _ in range(3):
        _same(cq.run(), want)
    assert cq.n_replays == 3
    assert ops.calls["dense_agg"] == calls
    plain = CompiledQuery(QUERIES[qname](), db, preset("opt"))
    _same(plain.run(), want)


def _q3_bindings(runtime, n):
    # a day of March 1995 and the segments' one validation value
    dated = [k for k, v in runtime.items() if isinstance(v, int)]
    return [dict(runtime, **{k: runtime[k] - 15 + (i % 31) for k in dated})
            for i in range(n)]


def test_run_many_of_q3_equals_its_runs(db):
    """A 64-binding pass of q3 (one batched launch) against 64 runs.  The
    first full pass captures the pass as one graph: one launch in its
    eager warm pass and one recorded into the graph; its replays launch
    the kernel without calling it."""
    cq, runtime = _param_query(db, "q3")
    cq.compile()
    bindings = _q3_bindings(runtime, 64)
    launched = kd.launches["dense_agg_batched"]
    many = cq.run_many(bindings)
    assert cq.n_pass_replays == 1, cq.pass_capture_error
    assert kd.launches["dense_agg_batched"] == launched + 2
    for b, got in zip(bindings, many):
        _same(got, cq.run(b))
    with cq._pass_lock:             # a pass that finds it held is eager
        again = cq.run_many(bindings)
    assert kd.launches["dense_agg_batched"] == launched + 3
    assert cq.n_pass_replays == 1
    for w, got in zip(many, again):
        _same(got, w)


def test_four_threads_under_the_profiler(db):
    """Four threads run q3's 64-binding pass at once while a profiler
    started in this thread records: the traced report service's shape.
    Every answer is checked."""
    cq, runtime = _param_query(db, "q3")
    cq.compile()
    bindings = _q3_bindings(runtime, 64)
    want = [cq.run(b) for b in bindings]
    # the full pass captured before the profiler starts, as the report
    # service captures in its set-up: one thread replays, the others
    # find the graph busy and run the eager pass
    cq.run_many(bindings)
    errors, done = [], []

    def worker(k):
        try:
            for _ in range(3):
                for w, got in zip(want, cq.run_many(bindings)):
                    _same(got, w)
                done.append(k)
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append((k, e))

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(done) == 12
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("repro::" in n and "dense_agg" in n for n in names)
