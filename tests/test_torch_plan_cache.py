"""The port's plan cache on the CPU against the reference's: the same
request sequence through `repro.core.PlanCache` and
`repro_torch.core.PlanCache(device="cpu")` at sf 0.01, seed 0, gives the
same answers (`test_queries.assert_same`: exact on ints, rtol 2e-3 on
floats), the same `CacheStats` (hits, misses, compiles, evictions and the
compaction counters) and the same `STAGINGS` deltas: one staging per plan
shape, none for a re-binding.  Beside it, what only the port has: the
default device is CUDA with no CPU fallback, a sharded setting raises,
and eviction, retirement and `close()` release an entry's resident
inputs.  The query server's cache-facing behaviour (concurrent requests,
one shared in-flight compilation, close under load) closes the file.

The helpers here (`Side`, `sides`, `stats_of`) serve the other
`test_torch_*` runtime files too.
"""
import dataclasses
import gc
import threading
import weakref
from types import ModuleType
from typing import Callable

import numpy as np
import pytest
import torch

import repro.core.compile as ref_compile
import repro_torch.core.compile as port_compile
from repro.core import CompiledQuery as RefCompiledQuery
from repro.core import PlanCache as RefPlanCache
from repro.core import VolcanoEngine as RefVolcano
from repro.core import preset as ref_preset
from repro.relational.queries import PARAM_ALT_BINDINGS as REF_ALT
from repro.relational.queries import PARAM_QUERIES as REF_PQ
from repro.relational.queries import QUERIES as REF_QUERIES
from repro.serve.query_server import QueryServer as RefQueryServer
from repro_torch.core import CompiledQuery, PlanCache, VolcanoEngine, preset
from repro_torch.relational import Database
from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                            PARAM_QUERIES, QUERIES)
from repro_torch.relational.schema import days
from repro_torch.serve.query_server import QueryServer
from test_queries import assert_same

CONFIGS = ["naive", "template", "tpch", "strdict", "opt", "opt-pallas"]
STAT_FIELDS = ("hits", "misses", "compiles", "evictions", "compactions",
               "overflows", "replans", "shrinks", "degraded")


@dataclasses.dataclass
class Side:
    """One package's runtime, called the same way for both: `cache`,
    `server` and `query` take the reference's arguments (the port's run
    on the CPU)."""
    name: str
    db: object
    cache: Callable
    server: Callable
    query: Callable
    preset: Callable
    compile_mod: ModuleType
    param_queries: dict
    alt: dict
    queries: dict
    oracle: object

    def stagings(self) -> int:
        return self.compile_mod.STAGINGS

    def plan(self, qname: str):
        return self.param_queries[qname][0]()

    def defaults(self, qname: str) -> dict:
        return dict(self.param_queries[qname][1])

    def alt_bindings(self, qname: str) -> dict:
        return dict(self.param_queries[qname][1], **self.alt[qname])


def stats_of(cache) -> dict:
    return {f: getattr(cache.stats, f) for f in STAT_FIELDS}


def assert_matches(got, want):
    # param results compare row-order-insensitively: ties under
    # alternative bindings may sort differently between engines
    assert_same(got, want, sort_insensitive=True)


@pytest.fixture(scope="module")
def pdb():
    return Database.tpch(sf=0.01, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: beside other pytest-xdist workers, a thread per
    core oversubscribes the cores and slows every worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sides(db, pdb):
    ref = Side("reference", db, RefPlanCache, RefQueryServer,
               RefCompiledQuery, ref_preset, ref_compile, REF_PQ, REF_ALT,
               REF_QUERIES, RefVolcano(db))
    port = Side("port", pdb,
                lambda d, *a, **k: PlanCache(d, *a, device="cpu", **k),
                lambda d, *a, **k: QueryServer(d, *a, device="cpu", **k),
                lambda *a, **k: CompiledQuery(*a, device="cpu", **k),
                preset, port_compile, PARAM_QUERIES, PARAM_ALT_BINDINGS,
                QUERIES, VolcanoEngine(pdb))
    return ref, port


def run_both(sides, seq):
    """`seq(side)` -> (results, observations) on each package, with the
    STAGINGS delta added; returns (reference's, port's) with the answers
    held equal."""
    out = []
    for side in sides:
        before = side.stagings()
        results, obs = seq(side)
        out.append((results, dict(obs, stagings=side.stagings() - before)))
    (ref_res, ref_obs), (port_res, port_obs) = out
    assert len(ref_res) == len(port_res)
    for r, p in zip(ref_res, port_res):
        assert_matches(p, r)
    assert port_obs == ref_obs
    return ref_obs


# ---------------------------------------------------------------------------
# one staging per shape, the reference's accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", CONFIGS)
def test_rebind_single_staging_like_the_reference(sides, config):
    def seq(s):
        cache = s.cache(s.db)
        res = [cache.execute(s.plan("q6"), s.preset(config), b)
               for b in (s.defaults("q6"), s.alt_bindings("q6"))]
        return res, stats_of(cache)

    obs = run_both(sides, seq)
    assert obs["stagings"] == 1 and obs["compiles"] == 1
    assert (obs["hits"], obs["misses"]) == (1, 1)


@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_param_bound_equals_literal_baked(sides, qname):
    """Default bindings reproduce the literal query; alternative bindings
    give the reference's answer under the same bindings."""
    _ref, port = sides

    def seq(s):
        cache = s.cache(s.db)
        got = cache.execute(s.plan(qname), s.preset("opt"), s.defaults(qname))
        alt = cache.execute(s.plan(qname), s.preset("opt"),
                            s.alt_bindings(qname))
        return [got, alt], stats_of(cache)

    run_both(sides, seq)
    cache = port.cache(port.db)
    got = cache.execute(port.plan(qname), preset("opt-pallas"),
                        port.defaults(qname))
    literal = port.query(QUERIES[qname](), port.db, preset("opt")).run()
    assert_matches(got, literal)


def test_specialize_mode_bakes_every_binding(sides):
    def seq(s):
        cache = s.cache(s.db)
        d, a = s.defaults("q6"), s.alt_bindings("q6")
        res = [cache.execute(s.plan("q6"), s.preset("opt"), b,
                             mode="specialize") for b in (d, a, d)]
        assert not np.allclose(res[0]["revenue"], res[1]["revenue"])
        return res, stats_of(cache)

    obs = run_both(sides, seq)
    assert obs["compiles"] == 2 and obs["hits"] == 1


def test_structural_params_key_the_cache(sides):
    def seq(s):
        cache = s.cache(s.db)
        d = s.defaults("q3")
        reqs = [d, dict(d, cutoff=days("1995-06-15")),
                dict(d, segment="MACHINERY"), dict(d, topn=5),
                dict(d, topn=5)]
        res, compiles = [], []
        for b in reqs:
            res.append(cache.execute(s.plan("q3"), s.preset("opt"), b))
            compiles.append(cache.stats.compiles)
        assert len(next(iter(res[-1].values()))) == 5
        return res, dict(stats_of(cache), compiles_after=compiles)

    assert run_both(sides, seq)["compiles_after"] == [1, 1, 2, 3, 3]


def test_missing_compile_time_binding_raises(sides):
    _ref, port = sides
    partial = {k: v for k, v in port.defaults("q3").items()
               if k != "segment"}
    with pytest.raises(KeyError, match="segment"):
        port.cache(port.db).execute(port.plan("q3"), preset("opt"), partial)


def test_cache_lru_eviction_order_and_recompile(sides):
    def seq(s):
        cache = s.cache(s.db, max_entries=2)
        d = s.defaults("q6")
        res = []
        for p in ("opt", "tpch", "opt", "naive", "tpch", "tpch"):
            res.append(cache.execute(s.plan("q6"), s.preset(p), d))
        keys = {p: cache.contains(cache.key_for(s.plan("q6"), s.preset(p),
                                                d))
                for p in ("opt", "tpch", "naive")}
        return res, dict(stats_of(cache), contains=keys, size=len(cache))

    obs = run_both(sides, seq)
    assert obs["evictions"] == 2 and obs["compiles"] == 4
    assert obs["stagings"] == 4 and obs["size"] == 2
    assert obs["contains"] == {"opt": False, "tpch": True, "naive": True}


def test_db_identity_uses_fingerprint_not_id(pdb):
    f1 = Database({}).fingerprint
    gc.collect()
    seen = {Database({}).fingerprint for _ in range(20)}
    assert f1 not in seen and len(seen) == 20
    key = PlanCache(pdb, device="cpu").key_for(QUERIES["q6"](),
                                               preset("opt"))
    assert key[2] == pdb.fingerprint


def test_reload_invalidates_capacity_memo_and_entries(sides):
    """A `Database.reload` bumps the fingerprint: the memoized capacity
    vector and the staged entry of the old data are not reused, and the
    new vector is the reference's for the same new data."""
    ref, _port = sides
    db = Database.tpch(sf=0.01, seed=0)
    cache = PlanCache(db, device="cpu")
    k1 = cache.key_for(QUERIES["q3"](), preset("opt"))
    assert k1[-1] == ref.cache(ref.db).key_for(REF_QUERIES["q3"](),
                                               ref_preset("opt"))[-1]
    cache.execute(QUERIES["q3"](), preset("opt"))
    db.reload(Database.tpch(sf=0.002, seed=1).tables)
    k2 = cache.key_for(QUERIES["q3"](), preset("opt"))
    assert k2 != k1 and k2[-1] != k1[-1]
    from repro.relational import Database as RefDatabase
    assert k2[-1] == RefPlanCache(RefDatabase.tpch(sf=0.002, seed=1)).key_for(
        REF_QUERIES["q3"](), ref_preset("opt"))[-1]
    cache.execute(QUERIES["q3"](), preset("opt"))
    assert cache.stats.compiles == 2


# ---------------------------------------------------------------------------
# what only the port has: the device, the mesh, and resident memory
# ---------------------------------------------------------------------------

def test_sharded_settings_raise(pdb):
    cache = PlanCache(pdb, device="cpu")
    with pytest.raises(NotImplementedError, match="shards"):
        cache.key_for(QUERIES["q6"](), dataclasses.replace(preset("opt"),
                                                           shards=2))


def _released(refs) -> bool:
    gc.collect()
    return all(r() is None for r in refs)


def test_eviction_retirement_and_close_release_the_entry(sides):
    """The cache keeps no reference to an evicted, retired or closed-over
    entry, nor to its twin or its resident inputs."""
    _ref, port = sides
    cache = port.cache(port.db, max_entries=1)
    d = port.defaults("q6")
    cq, _ = cache.get(port.plan("q6"), preset("opt"), d)
    refs = [weakref.ref(cq)] + [weakref.ref(t) for t in cq.resident.values()]
    del cq
    cache.execute(port.plan("q6"), preset("naive"), d)     # evicts opt
    assert cache.stats.evictions == 1 and _released(refs)

    # retirement: a re-plan after overflows drops the entry and its twin
    s = dataclasses.replace(preset("opt"), compact_replan_after=1)
    from repro_torch.core.expr import Cmp, col, lit
    from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select

    def plan():
        sel = Select(Scan("lineitem"), Cmp("<", col("l_quantity"), lit(2.0)))
        return Agg(Compact(sel, 64), [], [AggSpec("c", "count")])

    cache = port.cache(port.db)
    cq, _ = cache.get(plan(), s)
    cq.run()
    assert cq.n_overflows == 1
    refs = [weakref.ref(cq), weakref.ref(cq._fallback_query())]
    del cq
    cache.execute(plan(), s)
    assert cache.stats.replans == 1
    assert _released(refs)

    cq, _ = cache.get(plan(), s)
    refs = [weakref.ref(cq)]
    del cq
    cache.close()
    assert len(cache) == 0 and _released(refs)


# ---------------------------------------------------------------------------
# the server over the cache
# ---------------------------------------------------------------------------

def test_server_interleaved_concurrent_requests(sides):
    def seq(s):
        d6, d3 = s.defaults("q6"), s.defaults("q3")
        reqs = [(s.plan("q6"), d6), (s.plan("q3"), d3),
                (s.plan("q6"), s.alt_bindings("q6")),
                (s.plan("q3"), dict(d3, cutoff=days("1995-06-15"))),
                (s.plan("q6"), d6)]
        with s.server(s.db, s.preset("opt"), max_workers=4) as srv:
            futs = [srv.submit(p, dict(b)) for p, b in reqs]
            srv.flush()
            res = [f.result(timeout=120) for f in futs]
            st = srv.stats
        return res, {"completed": st.completed, "errors": st.errors,
                     "compiles": srv.cache.stats.compiles}

    assert run_both(sides, seq)["compiles"] == 2


def test_server_shares_one_inflight_compilation(sides):
    """Two concurrent requests for one plan shape: the second parks on
    the first's in-flight compilation; exactly one staging happens."""
    _ref, port = sides
    gate, started = threading.Event(), threading.Event()

    def hook(_key):
        started.set()
        assert gate.wait(timeout=60)

    d, alt = port.defaults("q6"), port.alt_bindings("q6")
    before = port.stagings()
    with port.server(port.db, preset("opt-pallas"), compile_hook=hook,
                     max_workers=4, window_s=0.001) as srv:
        f1 = srv.submit(port.plan("q6"), d)
        assert started.wait(timeout=60)
        f2 = srv.submit(port.plan("q6"), alt)
        srv.flush()
        while srv.stats.shared_compiles == 0 and not f2.done():
            threading.Event().wait(0.01)
        gate.set()
        r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
        assert srv.stats.shared_compiles == 1
        assert srv.cache.stats.compiles == 1
    assert port.stagings() - before == 1
    assert_matches(r1, port.oracle.execute(port.plan("q6"), d))
    assert_matches(r2, port.oracle.execute(port.plan("q6"), alt))


def test_close_under_load_resolves_every_future(sides):
    """Submitters hammer the server while it closes: every future that
    `submit` returned resolves, and no server thread outlives close()."""
    _ref, port = sides
    d, alt = port.defaults("q6"), port.alt_bindings("q6")
    futs, futs_lock = [], threading.Lock()
    stop, first = threading.Event(), threading.Event()
    srv = port.server(port.db, preset("opt"), max_workers=2,
                      window_s=0.002, max_batch=4)

    def hammer(i):
        while not stop.is_set():
            try:
                f = srv.submit(port.plan("q6"), dict(d if i % 2 else alt))
            except RuntimeError:
                return            # server closed: expected once racing
            with futs_lock:
                futs.append(f)
            first.set()

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    assert first.wait(timeout=60)
    srv.submit(port.plan("q6"), dict(d)).result(timeout=120)
    srv.close()
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    with futs_lock:
        taken = list(futs)
    assert all(f.done() for f in taken)
    assert any(f.exception(timeout=0) is None for f in taken)
    assert not srv._flusher.is_alive()
    assert not any(t.is_alive() for t in srv._pool._threads)
