"""Bind-many on a data mesh in the port, on the CPU over virtual device
slots (`mesh.virtual_devices("cpu", 4)`), at sf 0.01, seed 0, torch on
one thread, vmap's per-example fallback off (an operator with no
batching rule fails instead of looping over the bindings):

  * a sharded `run_many` is ONE staged walk under `torch.func.vmap` in
    each shard's thread (the counterpart of the reference's
    `shard_wrap(fn_many)`), for the six parameterized queries at `opt`
    and `opt-pallas` on 2 and 4 slots, through `PlanCache.execute_many`
    and the query server's coalescing window: every slot bit for bit
    the sharded `run` of its binding, and under
    `test_queries.assert_same` the reference's unsharded `run_many` (its
    sharded program fails under jax 0.9's `check_vma`) and the port's
    Volcano;
  * `execute_shards_many`: every shard bit for bit shard 0, the counts
    (N, n_shards); `observed_shard` after a pass equals N sharded runs';
    a planted point that one slot overflows re-runs that slot alone;
    `run_batched` and `compile()` on a mesh; each shard's block of a
    partitioned input its own 16-byte aligned allocation;
  * each collective under vmap over 3 threads against numpy, with every
    shard's value batched, some or none, and never a vmapped tensor in
    a shard group's slot; a shard that raises inside vmap fails the
    call without a hang;
  * `CompiledQueryBatch`'s one set of resident inputs.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (CompiledQuery, CompiledQueryBatch, PlanCache,
                              preset)
from repro_torch.core import compile as compile_mod
from repro_torch.core import mesh
from repro_torch.core.backend import TorchBackend
from repro_torch.core.expr import Cmp, Param, col
from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select
from repro_torch.relational.queries import PARAM_QUERIES, QUERIES
from test_torch_plan_cache import assert_matches, pdb, sides  # noqa: F401

SHARDS = [2, 4]
PRESETS = ["opt", "opt-pallas"]
SIZES = [3, 16]


@pytest.fixture(scope="module", autouse=True)
def one_thread_no_fallback():
    """One torch thread (beside other pytest-xdist workers, a thread per
    core oversubscribes the cores); an op with no batching rule raises
    instead of looping."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def four_slots():
    mesh.virtual_devices("cpu", 4)
    yield
    mesh.virtual_devices("cpu", 1)


def sharded(pname: str, n: int):
    return dataclasses.replace(preset(pname), shards=n)


def bindings(side, qname: str, n: int) -> list[dict]:
    """n full bindings of a parameterized query: the defaults, the
    alternative, then steps between them (an integer parameter rounded),
    so that the first 3 of 16 are the 3."""
    d, alt = side.defaults(qname), side.alt_bindings(qname)
    out = [d, alt]
    for i in range(2, n):
        t = (i - 1) / 16
        out.append({k: v if isinstance(v, str) or v == alt[k]
                    else type(v)(round(v + (alt[k] - v) * t, 2))
                    for k, v in d.items()})
    return out[:n]


def param_overflow_plan():
    """count and sum over `l_quantity < qmax` through a hand-planted
    64-row compaction point (64 rows a shard under a mesh)."""
    sel = Select(Scan("lineitem"),
                 Cmp("<", col("l_quantity"), Param("qmax", "float32")))
    return Agg(Compact(sel, 64), [],
               [AggSpec("s", "sum", col("l_extendedprice")),
                AggSpec("c", "count")])


def runtime_of(cq, full: list[dict]) -> list[dict]:
    return [{k: b[k] for k in cq.param_spec} for b in full]


def assert_bits(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert got[k].tobytes() == want[k].tobytes(), (what, k)


class WalkCounter:
    """Counts a query's staged walks by shard rank."""

    def __init__(self, cq):
        self.by_rank: dict = {}
        self._lock = threading.Lock()
        real = cq._walk

        def walk(inputs, device, group=None, rank=0, token=None):
            with self._lock:
                self.by_rank[rank] = self.by_rank.get(rank, 0) + 1
            return real(inputs, device, group, rank, token)
        cq._walk = walk


@pytest.fixture(scope="module")
def ref_many(sides):
    """(qname, n) -> the reference's unsharded `run_many` of the n
    bindings at opt, computed once."""
    ref, _port = sides
    memo = {}

    def get(qname, n):
        if (qname, n) not in memo:
            cache = ref.cache(ref.db)
            full = bindings(ref, qname, n)
            rcq, _rt = cache.get(ref.plan(qname), ref.preset("opt"), full[0])
            memo[qname, n] = rcq.run_many(
                [{k: b[k] for k in rcq.param_spec} for b in full])
        return memo[qname, n]
    return get


@pytest.fixture(scope="module")
def volcano(sides):
    """(qname, i) -> the port's Volcano under binding i of 16."""
    _ref, port = sides
    memo = {}

    def get(qname, i):
        if (qname, i) not in memo:
            memo[qname, i] = port.oracle.execute(
                port.plan(qname), bindings(port, qname, 16)[i])
        return memo[qname, i]
    return get


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("pname", PRESETS)
@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_sharded_run_many_is_one_pass(sides, ref_many, volcano, qname,
                                      pname, n, size):
    """Through the plan cache: one execution, one walk a shard, no
    staging; each slot the sharded `run` of its binding bit for bit, the
    reference's unsharded `run_many` and the port's Volcano."""
    _ref, port = sides
    cache = PlanCache(port.db, device="cpu")
    s = sharded(pname, n)
    full = bindings(port, qname, size)
    cq, _rt = cache.get(port.plan(qname), s, full[0])
    assert cq.n_shards == n
    walks = WalkCounter(cq)
    before, execs = compile_mod.STAGINGS, cq.n_executions
    got = cache.execute_many(port.plan(qname), s, full)
    assert compile_mod.STAGINGS == before, "a pass must not re-stage"
    assert cq.n_executions - execs == 1, "one batched pass"
    assert walks.by_rank == {r: 1 for r in range(n)}, walks.by_rank
    assert cq.n_overflows == 0
    want = ref_many(qname, size)
    for i, (g, b) in enumerate(zip(got, runtime_of(cq, full))):
        assert_bits(g, cq.run(b), (qname, i))
        assert_matches(g, want[i])
        assert_matches(g, volcano(qname, i))
    cache.close()


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_execute_shards_many_is_bit_identical(sides, qname, n):
    """Every shard's columns, mask and counts bit for bit shard 0's, each
    with the N bindings in front; `execute_many`'s counts (N, n_shards),
    each slot's row the sharded walk's of its binding."""
    _ref, port = sides
    cache = PlanCache(port.db, device="cpu")
    full = bindings(port, qname, 5)
    cq, _rt = cache.get(port.plan(qname), sharded("opt-pallas", n), full[0])
    rts = runtime_of(cq, full)
    shards = cq.execute_shards_many(cq.bind_many(rts))
    out0, mask0, counts0 = shards[0]
    assert mask0.shape[0] == 5
    for out, mask, counts in shards[1:]:
        assert set(out) == set(out0) and set(counts) == set(counts0)
        for k in out0:
            assert torch.equal(out[k], out0[k]), k
        assert torch.equal(mask, mask0)
    _o, _m, counts = cq.execute_many(cq.bind_many(rts))
    for pid, c in counts.items():
        assert c.shape == (5, n), (pid, c.shape)
        for i, b in enumerate(rts):
            one = cq.execute(cq.bind(b))[2][pid]
            assert torch.equal(c[i], one), (pid, i)
    cache.close()


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("qname", ["q3", "q12"])
def test_observed_shard_after_a_pass_equals_runs(sides, qname, n):
    """The per-shard maxima and the all-time maxima after one pass of 16
    bindings are those after 16 sharded runs of a second entry."""
    _ref, port = sides
    full = bindings(port, qname, 16)
    s = sharded("opt", n)
    a, _ = PlanCache(port.db, device="cpu").get(port.plan(qname), s, full[0])
    b, _ = PlanCache(port.db, device="cpu").get(port.plan(qname), s, full[0])
    a.run_many(runtime_of(a, full))
    for r in runtime_of(b, full):
        b.run(r)
    assert a.n_executions == 1 and b.n_executions == 16
    assert a.observed_shard and set(a.observed_shard) == set(b.observed_shard)
    for pid, v in b.observed_shard.items():
        assert a.observed_shard[pid].shape == (n,)
        np.testing.assert_array_equal(a.observed_shard[pid], v, err_msg=pid)
    assert a.observed_max == b.observed_max


@pytest.mark.parametrize("n", SHARDS)
def test_planted_overflow_reruns_only_that_slot(pdb, n):
    """A hand-planted 64-row point that slot 2 of 5 overflows on its
    worst shard: one overflow, the twin runs once (one binding: one
    scalar walk), and every slot equals the unsharded CPU answer."""
    lo, hi = {"qmax": 1.0}, {"qmax": 26.0}
    s = dataclasses.replace(sharded("opt", n), compaction=False)
    cq = CompiledQuery(param_overflow_plan(), pdb, s, params=lo,
                       device="cpu")
    bl = [hi if i == 2 else lo for i in range(5)]
    got = cq.run_many(bl)
    assert cq.n_executions == 1 and cq.n_overflows == 1
    assert cq._fallback is not None and cq._fallback.n_executions == 1
    assert cq.observed_max["h0"] > 64
    one = CompiledQuery(param_overflow_plan(), pdb, preset("opt"),
                        params=lo, device="cpu")
    for i, g in enumerate(got):
        assert_matches(g, one.run(bl[i]))


@pytest.mark.parametrize("n", SHARDS)
def test_run_batched_and_compile_on_a_mesh(pdb, n):
    """`compile()` builds the batched pass on a mesh too (one walk a
    shard for the scalar walk, one for the pass), counting nothing;
    `run_batched` of 2 bindings is one pass equal to 2 runs."""
    build, d = PARAM_QUERIES["q6"]
    cq = CompiledQuery(build(), pdb, sharded("opt-pallas", n), params=d,
                       device="cpu")
    walks = WalkCounter(cq)
    assert cq.compile() >= 0.0
    assert walks.by_rank == {r: 2 for r in range(n)}
    assert cq.n_executions == 0
    bl = [d, dict(d, qty_max=30.0)]
    got = cq.run_batched(bl)
    assert cq.n_executions == 1
    for g, b in zip(got, bl):
        assert_bits(g, cq.run(b), b)


@pytest.mark.parametrize("n", SHARDS)
def test_shard_blocks_are_aligned_allocations(pdb, n):
    """Each shard's block of a partitioned input is an allocation of its
    own at a 16-byte aligned address: lineitem's padded blocks at sf
    0.01 (an odd row count a block) would start off the boundary as
    views of one tensor."""
    cq = CompiledQuery(QUERIES["q12"](), pdb, sharded("opt-pallas", n),
                       device="cpu")
    keys = sorted(k for k in cq.sharded_keys if k.startswith("lineitem"))
    assert keys
    rows = cq.inputs[keys[0]].shape[0] // n
    assert rows % 4, "every block would be aligned as a view too"
    for k in cq.sharded_keys:
        ptrs = {cq.shard_resident[s][k].untyped_storage().data_ptr()
                for s in range(n)}
        assert len(ptrs) == n, k
        for s in range(n):
            t = cq.shard_resident[s][k]
            assert t.is_contiguous() and t.data_ptr() % 16 == 0, (k, s)


def test_server_coalesces_on_a_mesh(sides):
    """16 q6 requests inside one window of a server on a 2-slot mesh: one
    `run_many`, one batched pass, each answer the reference's Volcano."""
    ref, port = sides
    full = bindings(port, "q6", 16)
    s = sharded("opt-pallas", 2)
    with port.server(port.db, s, window_s=3600.0, max_batch=128) as srv:
        futs = [srv.submit(port.plan("q6"), b) for b in full]
        srv.drain()
        results = [f.result(timeout=60) for f in futs]
        assert srv.stats.batches == 1 and srv.stats.coalesced == 16
        cq, _ = srv.cache.get(port.plan("q6"), s, full[0])
        assert cq.n_shards == 2 and cq.n_executions == 1
    for b, got in zip(full, results):
        assert_matches(got, ref.oracle.execute(ref.plan("q6"), b))


# ---------------------------------------------------------------------------
# the collectives under vmap
# ---------------------------------------------------------------------------

COLLECTIVES = {
    "psum": (lambda be, x: be.psum(x, mesh.AXIS),
             lambda xs: np.sum(xs, axis=0)),
    "pmax": (lambda be, x: be.pmax(x, mesh.AXIS),
             lambda xs: np.max(xs, axis=0)),
    "pmin": (lambda be, x: be.pmin(x, mesh.AXIS),
             lambda xs: np.min(xs, axis=0)),
    "all_gather_tiled": (
        lambda be, x: be.all_gather(x, mesh.AXIS, tiled=True),
        lambda xs: np.concatenate(xs)),
    "all_gather": (lambda be, x: be.all_gather(x, mesh.AXIS),
                   lambda xs: np.stack(xs)),
}
# which of the 3 shards' values depend on the bindings
BATCHED = {"all": (True, True, True), "mixed": (True, False, True),
           "none": (False, False, False)}


@pytest.mark.parametrize("batched", sorted(BATCHED))
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_under_vmap_over_three_threads(name, dtype, batched):
    """Each shard runs vmap over 4 bindings; its value is its base row
    plus the binding's offset where it is batched, the base row alone
    where not.  Every shard gets, for every binding, the numpy answer of
    that binding's values, bit for bit the same on every shard; no slot
    of the group ever holds a vmapped tensor."""
    op, ref = COLLECTIVES[name]
    rng = np.random.default_rng(11)
    base = [rng.integers(-50, 50, size=5).astype(dtype) for _ in range(3)]
    offs = np.arange(4, dtype=dtype) * 7
    flags = BATCHED[batched]
    m = mesh.data_mesh(3, "cpu")
    seen = []
    real = mesh.ShardGroup.exchange_batched

    def exchange_batched(self, rank, x, b):
        seen.append(torch._C._functorch.is_batchedtensor(x))
        return real(self, rank, x, b)

    def fn(rank, group, x):
        def one(off):
            be = TorchBackend("cpu", group, rank, token=off)
            v = torch.from_numpy(x)
            return op(be, v + off if flags[rank] else v)
        return torch.func.vmap(one)(torch.from_numpy(offs))

    mesh.ShardGroup.exchange_batched = exchange_batched
    try:
        outs = m.run(fn, base)
    finally:
        mesh.ShardGroup.exchange_batched = real
    assert len(seen) == 3 and not any(seen)
    for j, off in enumerate(offs):
        want = ref([b + off if f else b for b, f in zip(base, flags)])
        for rank, got in enumerate(outs):
            assert got.shape[0] == 4
            np.testing.assert_array_equal(got[j].numpy(), want)
            assert got[j].numpy().tobytes() == outs[0][j].numpy().tobytes()


def test_a_slot_refuses_a_vmapped_tensor():
    """A collective called under vmap without its token (so without its
    batching rule) would put a thread's vmapped tensor into a slot: the
    group refuses it, and the run fails without a hang."""
    m = mesh.data_mesh(2, "cpu")

    def fn(rank, group, x):
        be = TorchBackend("cpu", group, rank)
        return torch.func.vmap(lambda v: be.psum(v, mesh.AXIS))(x)

    with pytest.raises(TypeError, match="plain tensor"):
        m.run(fn, [torch.ones(3, 2), torch.ones(3, 2)])


@pytest.mark.parametrize("where", ["collective", "before_any_collective"])
def test_failing_shard_in_vmap_fails_without_hang(pdb, monkeypatch, where):
    """Shard 1 raises inside the batched walk (inside a collective, or
    in its scan before any): `run_many` raises that error within
    seconds, the other shards leave the barrier, and the next pass
    answers as before."""
    from repro_torch.core import ir
    from repro_torch.core.operators import _DISPATCH, scan

    build, d = PARAM_QUERIES["q6"]
    cq = CompiledQuery(build(), pdb, sharded("opt", 4), params=d,
                       device="cpu")
    bl = [d, dict(d, qty_max=30.0), d]
    want = cq.run_many(bl)

    class Injected(RuntimeError):
        pass

    if where == "collective":
        real = TorchBackend.psum

        def psum(self, x, axis):
            if self.rank == 1:
                raise Injected("shard 1 failed")
            return real(self, x, axis)
        monkeypatch.setattr(TorchBackend, "psum", psum)
    else:
        real = scan.stage

        def stage(node, ctx, defer=False):
            if ctx.backend.rank == 1 and ctx.backend.group is not None:
                raise Injected("shard 1 failed")
            return real(node, ctx, defer)
        monkeypatch.setitem(_DISPATCH, ir.Scan, stage)
    before = threading.active_count()
    t0 = time.perf_counter()
    with pytest.raises(Injected):
        cq.run_many(bl)
    assert time.perf_counter() - t0 < 10
    assert threading.active_count() <= before
    monkeypatch.undo()
    for g, w in zip(cq.run_many(bl), want):
        assert_bits(g, w, where)


# ---------------------------------------------------------------------------
# CompiledQueryBatch: one set of resident inputs
# ---------------------------------------------------------------------------

BATCH = ("q1", "q3", "q6", "q14")


def test_batch_holds_each_input_key_once(pdb):
    """Each input key is one resident tensor, shared by every member that
    reads it, holding the host array's bytes after two batch runs and a
    run of each member alone (no operator writes into it); the answers
    of the three are bit-identical."""
    batch = CompiledQueryBatch([QUERIES[q]() for q in BATCH], pdb,
                               preset("opt-pallas"), device="cpu")
    held: dict = {}
    for q in batch.queries:
        for k, t in q.resident.items():
            held.setdefault(k, set()).add(t.untyped_storage().data_ptr())
    assert all(len(p) == 1 for p in held.values())
    assert set(held) == {k for k in batch.inputs
                         if not k.startswith("param/")}
    shared = [k for k in held if sum(k in q.resident
                                     for q in batch.queries) > 1]
    assert shared, "the batch's plans share no input"
    first, second = batch.run(), batch.run()
    alone = [q.run() for q in batch.queries]
    for q, a, b, c in zip(BATCH, first, second, alone):
        assert_bits(b, a, q)
        assert_bits(c, a, q)
    for q in batch.queries:
        for k, t in q.resident.items():
            assert t.numpy().tobytes() == batch.inputs[k].tobytes(), k


def test_batch_refuses_differing_arrays_under_one_key(monkeypatch):
    """Two plans whose host arrays under one input key differ (the
    database's column changed between them) are refused, not silently
    served from the first one's tensor."""
    from repro_torch.relational import Database

    db = Database.tpch(sf=0.01, seed=0)
    qty = db.table("lineitem").data["l_quantity"]
    real = CompiledQuery.__init__
    built = []

    def init(self, *a, **k):
        real(self, *a, **k)
        built.append(self)
        db.table("lineitem").data["l_quantity"] = qty + 1.0

    monkeypatch.setattr(CompiledQuery, "__init__", init)
    with pytest.raises(ValueError, match="l_quantity"):
        CompiledQueryBatch([QUERIES["q6"](), QUERIES["q1"]()], db,
                           preset("opt"), device="cpu")
    assert len(built) == 2
