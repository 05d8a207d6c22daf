"""Sharded execution in the port, on the CPU over virtual device slots
(`repro_torch.core.mesh.virtual_devices("cpu", 4)`, the counterpart of
the 8 virtual XLA devices `tests/conftest.py` gives the reference), at
sf 0.01, seed 0:

  * the port's `optimize()` equals the reference's, by `repr`, for every
    query at `opt` and `opt-pallas` with 2 and 4 shards (the Sharding
    pass, its Exchange placement and the per-shard capacities), and the
    collection walk registers the reference's input keys and sharded
    keys;
  * every query's sharded answer, run twice, equals the reference's
    unsharded `CompiledQuery` and both Volcano engines under
    `test_queries.assert_same` (exact on ints, rtol 2e-3 on floats), and
    every shard's output is bit-identical (the reference's sharded `run`
    fails under jax 0.9's `check_vma` for most queries, so its
    unsharded answer is the reference here);
  * `observed_shard` equals the reference's for q1 and q6 at 2 shards,
    and the per-shard counts of a hand-planted compaction point equal a
    numpy count of each shard's block;
  * the mesh: `resolve_shards`, `CompiledQueryBatch` refusing a mesh,
    `run_many` on a mesh, each collective over 3 threads against numpy,
    and a shard that raises failing `run()` without a hang.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import CompiledQuery as RefCompiledQuery
from repro.core import VolcanoEngine as RefVolcano
from repro.core import ir as RIR
from repro.core import preset as ref_preset
from repro.core.passes.pipeline import optimize as ref_optimize
from repro.relational.queries import QUERIES as REF_QUERIES
from repro_torch.core import (CompiledQuery, CompiledQueryBatch, PlanCache,
                              VolcanoEngine, optimize, preset)
from repro_torch.core import ir as PIR
from repro_torch.core import mesh
from repro_torch.core.backend import TorchBackend
from repro_torch.core.expr import Cmp, col, lit
from repro_torch.relational import Database
from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                            PARAM_QUERIES, QUERIES)
from test_queries import SORT_INSENSITIVE, assert_same

SHARDS = [2, 4]
PRESETS = ["opt", "opt-pallas"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's small queries run on one torch thread: beside other
    pytest-xdist workers, torch's default of a thread per core
    oversubscribes the cores and slows every worker several times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def four_slots():
    """Four virtual slots on the CPU for every test of the module, the
    CPU's one real device again after it."""
    mesh.virtual_devices("cpu", 4)
    yield
    mesh.virtual_devices("cpu", 1)


@pytest.fixture(scope="module")
def pdb():
    return Database.tpch(sf=0.01, seed=0)


@pytest.fixture(scope="module")
def want(db, pdb):
    """qname -> (reference unsharded CompiledQuery at opt, reference
    Volcano, port Volcano), each computed once."""
    ref_vol, port_vol = RefVolcano(db), VolcanoEngine(pdb)
    cache = {}

    def get(qname):
        if qname not in cache:
            cache[qname] = (
                RefCompiledQuery(REF_QUERIES[qname](), db,
                                 ref_preset("opt")).run(),
                ref_vol.execute(REF_QUERIES[qname]()),
                port_vol.execute(QUERIES[qname]()))
        return cache[qname]
    return get


def sharded(pname: str, n: int):
    return dataclasses.replace(preset(pname), shards=n)


def assert_shards_identical(shards):
    """Every shard's columns, mask and counts bit for bit shard 0's."""
    out0, mask0, counts0 = shards[0]
    for rank, (out, mask, counts) in enumerate(shards[1:], 1):
        assert set(out) == set(out0)
        for k in out0:
            assert torch.equal(out[k], out0[k]), (rank, k)
        assert torch.equal(mask, mask0), rank
        assert set(counts) == set(counts0)


# ---------------------------------------------------------------------------
# the plans: the Sharding pass against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("pname", PRESETS)
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_optimize_matches_reference(db, pdb, qname, pname, n):
    got = optimize(QUERIES[qname](), pdb, sharded(pname, n), device="cpu")
    ref = ref_optimize(REF_QUERIES[qname](), db,
                       dataclasses.replace(ref_preset(pname), shards=n))
    assert PIR.plan_repr(got) == RIR.plan_repr(ref)
    assert any(isinstance(s, PIR.Scan) and s.shard is not None
               for s in PIR.walk(got)), "nothing partitioned"


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_sharded_input_keys_match_reference(db, pdb, qname):
    """The collection walk registers the reference's inputs, the
    partitioned ones under the same shard-scoped keys."""
    ref = RefCompiledQuery(REF_QUERIES[qname](), db,
                           dataclasses.replace(ref_preset("opt"), shards=2))
    cq = CompiledQuery(QUERIES[qname](), pdb, sharded("opt", 2),
                       device="cpu")
    assert cq.n_shards == ref.n_shards == 2
    assert set(cq.inputs) == set(ref.inputs)
    assert cq.sharded_keys == ref.sharded_keys
    for k in cq.sharded_keys:
        np.testing.assert_array_equal(cq.inputs[k], np.asarray(ref.inputs[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# the answers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("pname", PRESETS)
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_sharded_answer_matches_oracles(want, pdb, qname, pname, n):
    ref_cq, ref_vol, port_vol = want(qname)
    cq = CompiledQuery(QUERIES[qname](), pdb, sharded(pname, n),
                       device="cpu")
    assert cq.n_shards == n
    si = qname in SORT_INSENSITIVE
    for _ in range(2):      # the second run merges the shard observations
        got = cq.run()
        assert_same(got, ref_cq, si)
        assert_same(got, ref_vol, si)
        assert_same(got, port_vol, si)
    assert cq.n_overflows == 0
    assert_shards_identical(cq.execute_shards(cq.bind()))


@pytest.mark.parametrize("qname", ["q1", "q6"])
def test_observed_shard_matches_reference(db, pdb, qname):
    ref = RefCompiledQuery(REF_QUERIES[qname](), db,
                           dataclasses.replace(ref_preset("opt"), shards=2))
    cq = CompiledQuery(QUERIES[qname](), pdb, sharded("opt", 2),
                       device="cpu")
    for _ in range(2):
        ref.run()
        cq.run()
    assert set(cq.observed_shard) == set(ref.observed_shard)
    for pid, v in ref.observed_shard.items():
        np.testing.assert_array_equal(cq.observed_shard[pid], v)
    assert cq.observed_max == ref.observed_max


def _compact_plan(capacity):
    """count and sum over `l_quantity < 26` through a hand-planted
    compaction point of `capacity` rows a shard."""
    sel = PIR.Select(PIR.Scan("lineitem"),
                     Cmp("<", col("l_quantity"), lit(26.0)))
    return PIR.Agg(PIR.Compact(sel, capacity), [],
                   [PIR.AggSpec("s", "sum", col("l_extendedprice")),
                    PIR.AggSpec("c", "count")])


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("fits", [False, True])
def test_observed_shard_counts_each_block(pdb, n, fits):
    """The per-shard counts of a compaction point are each shard's true
    count (a numpy count over the shard's block of the partitioned
    column); the worst shard decides the overflow, whose twin answers.
    A capacity that fits lies between a shard's count and its rows (about
    half of 30,191 rows at 2 shards, of 15,1xx at 4)."""
    capacity = {2: 16384, 4: 8192}[n] if fits else 1024
    s = dataclasses.replace(preset("opt"), shards=n, compaction=False)
    cq = CompiledQuery(_compact_plan(capacity), pdb, s, device="cpu")
    got = [cq.run() for _ in range(2)]
    sp = pdb.shard_plan(n)
    qty = sp.partition("lineitem", pdb.table("lineitem").data["l_quantity"])
    hits = (qty < 26.0) & sp.valid_mask("lineitem")
    per = hits.reshape(n, -1).sum(axis=1)
    np.testing.assert_array_equal(cq.observed_shard["h0"], per)
    assert cq.observed_max["h0"] == per.max()
    assert cq.n_overflows == (0 if fits else 2)
    assert (per.max() <= capacity) == fits
    want = VolcanoEngine(pdb).execute(_compact_plan(capacity))
    for g in got:
        assert_same(g, want, False)
        assert int(g["c"][0]) == per.sum()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_resolve_shards_cases():
    assert mesh.resolve_shards(preset("opt"), "cpu") == 1
    assert mesh.resolve_shards(preset("opt-shard"), "cpu") == 4
    assert mesh.resolve_shards(sharded("opt", 3), "cpu") == 3
    with pytest.raises(ValueError, match="shards=5"):
        mesh.resolve_shards(sharded("opt", 5), "cpu")
    mesh.virtual_devices("cpu", 1)
    assert mesh.resolve_shards(preset("opt-shard"), "cpu") == 1
    with pytest.raises(ValueError, match="only 1 devices"):
        mesh.resolve_shards(sharded("opt", 2), "cpu")


def test_optimize_resolves_shards_on_its_device(pdb):
    """`optimize(..., device=)` resolves `Settings.shards` against that
    device's slots: opt-shard partitions over the 4 virtual CPU slots,
    over none once the CPU has its one device back, and asking for more
    shards than the device has raises."""
    def shard_counts(settings):
        plan = optimize(QUERIES["q6"](), pdb, settings, device="cpu")
        return {s.shard.n_shards for s in PIR.walk(plan)
                if isinstance(s, PIR.Scan) and s.shard is not None}

    assert shard_counts(preset("opt-shard")) == {4}
    assert shard_counts(sharded("opt", 2)) == {2}
    mesh.virtual_devices("cpu", 1)
    assert shard_counts(preset("opt-shard")) == set()
    with pytest.raises(ValueError, match="shards=2"):
        shard_counts(sharded("opt", 2))


@pytest.mark.parametrize("qname", ["q3", "q12"])
def test_mesh_of_several_devices_copies_blocks(pdb, qname):
    """A mesh of distinct devices (`cpu` and `cpu:0`, which torch holds
    unequal) takes the several-device branches: every partitioned input
    is a copy of its own per shard (not a view of one tensor), and the
    collectives move each peer's tensor with `.to(device)`.  The answer
    is the one-device mesh's, bit for bit."""
    cq = CompiledQuery(QUERIES[qname](), pdb, sharded("opt-pallas", 2),
                       device="cpu")
    want = cq.run()
    key = sorted(cq.sharded_keys)[0]
    one = cq.shard_resident
    assert one[0][key].untyped_storage().data_ptr() \
        == one[1][key].untyped_storage().data_ptr()
    cq._mesh = mesh.DataMesh([torch.device("cpu"), torch.device("cpu", 0)])
    cq.shard_resident = cq._shard_blocks()
    two = cq.shard_resident
    assert two[0][key].untyped_storage().data_ptr() \
        != two[1][key].untyped_storage().data_ptr()
    for k in cq.sharded_keys:
        torch.testing.assert_close(torch.cat([two[0][k], two[1][k]]),
                                   torch.cat([one[0][k], one[1][k]]),
                                   rtol=0, atol=0)
    moved = []
    real = mesh.ShardGroup.exchange

    def exchange(self, rank, x):
        out = real(self, rank, x)
        # every slot is filled once the exchange has returned
        moved.append(any(v.device != self.devices[rank] for v in self.slots))
        return out
    mesh.ShardGroup.exchange = exchange
    try:
        got = cq.run()
    finally:
        mesh.ShardGroup.exchange = real
    assert any(moved)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_mesh_is_cached_per_device_list():
    m = mesh.data_mesh(3, "cpu")
    assert m is mesh.data_mesh(3, "cpu")
    assert m.n == 3 and m.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        mesh.data_mesh(5, "cpu")


def test_batch_refuses_a_mesh(pdb):
    with pytest.raises(NotImplementedError, match="shards"):
        CompiledQueryBatch([QUERIES["q6"]()], pdb, sharded("opt", 2),
                           device="cpu")


@pytest.mark.parametrize("qname", ["q6", "q12"])
def test_run_many_on_a_mesh_equals_runs(pdb, qname):
    """Through a plan cache, whose key carries the mesh size: a sharded
    entry's `run_many` of the default and alternative bindings equals
    as many `run`s, bit for bit, and the plan cache's `execute`."""
    cache = PlanCache(pdb, device="cpu")
    build, defaults = PARAM_QUERIES[qname]
    s = sharded("opt-pallas", 2)
    cq, rt = cache.get(build(), s, defaults)
    assert cq.n_shards == 2
    assert cache.key_for(build(), s, defaults)[3] == 2
    alt = dict(rt, **{k: v for k, v in PARAM_ALT_BINDINGS[qname].items()
                      if k in rt})
    bindings = [rt, alt, rt]
    got = cq.run_many(bindings)
    for g, b in zip(got, bindings):
        want = cq.run(b)
        assert set(g) == set(want)
        for k in g:
            np.testing.assert_array_equal(g[k], want[k], err_msg=k)
    served = cache.execute(build(), s, dict(defaults,
                                            **PARAM_ALT_BINDINGS[qname]))
    for k in served:
        np.testing.assert_array_equal(served[k], got[1][k], err_msg=k)
    cache.close()


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


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_over_three_threads(name, dtype):
    """Each collective over a 3-shard group: every shard gets the numpy
    answer, bit for bit the same on every shard (rank-order combine)."""
    op, ref = COLLECTIVES[name]
    rng = np.random.default_rng(7)
    xs = [rng.integers(-50, 50, size=5).astype(dtype) for _ in range(3)]
    m = mesh.data_mesh(3, "cpu")

    def fn(rank, group, x):
        be = TorchBackend("cpu", group, rank)
        return op(be, torch.from_numpy(x)), be.axis_index(mesh.AXIS)

    outs = m.run(fn, xs)
    want = ref(xs)
    for rank, (got, idx) in enumerate(outs):
        assert idx == rank
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().tobytes() == outs[0][0].numpy().tobytes()


def test_collectives_are_identities_without_a_group():
    be = TorchBackend("cpu")
    x = torch.arange(4, dtype=torch.int32)
    for name in ("psum", "pmax", "pmin", "all_gather_tiled"):
        assert torch.equal(COLLECTIVES[name][0](be, x), x)
    assert torch.equal(be.all_gather(x, mesh.AXIS), x[None])
    assert be.axis_index(mesh.AXIS) == 0


@pytest.mark.parametrize("where", ["collective", "before_any_collective"])
def test_failing_shard_fails_run_without_hang(pdb, monkeypatch, where):
    """Shard 1 raises (inside a collective, or in its scan before any):
    `run()` raises that error within seconds, the other shards are
    released from the barrier, and the next `run()` answers."""
    from repro_torch.core.operators import scan

    cq = CompiledQuery(QUERIES["q6"](), pdb, sharded("opt", 4), device="cpu")
    want = cq.run()

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
        monkeypatch.setitem(__import__(
            "repro_torch.core.operators", fromlist=["_DISPATCH"])._DISPATCH,
            PIR.Scan, stage)
    before = threading.active_count()
    t0 = time.perf_counter()
    with pytest.raises(Injected):
        cq.run()
    assert time.perf_counter() - t0 < 10
    assert threading.active_count() <= before
    monkeypatch.undo()
    got = cq.run()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
