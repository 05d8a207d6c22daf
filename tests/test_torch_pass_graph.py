"""A full bind-many pass replayed as one CUDA graph (`core/graphs.py`'s
`PassGraph`) where it runs on the CPU, at sf 0.01, seed 0: a pass on the
CPU never captures and its answers are unchanged; which passes replay
(`compile.replays_pass`: the number of bindings, the shards, the device,
the overflow twin), as plain Python; the pass as a capture runs it, its
parameters (64,) views of one fixed buffer written binding by binding,
which gives the answers of `bind_many`'s pass bit for bit; the scalar
walk's one-binding buffer of the same kind; and the count
of replayed passes, from a query's record through the plan cache to the
server.  The card's capture and replay are held to the eager pass in
`test_torch_pass_graph_cuda.py`."""
import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, PlanCache, graphs, preset
from repro_torch.core import compile as compile_mod
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.relational import Database
from repro_torch.relational.queries import PARAM_ALT_BINDINGS, PARAM_QUERIES
from repro_torch.serve.query_server import QueryServer

FULL = compile_mod.BATCH_MAX


@pytest.fixture(scope="module")
def pdb():
    return Database.tpch(sf=0.01, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def three_bindings(qname: str) -> list[dict]:
    """The template's default runtime bindings, its alternative, and a
    third: the alternative's dates two months earlier, or, where it has
    none (q19), its numbers one more."""
    build, defaults = PARAM_QUERIES[qname]
    spec = plan_params(build())
    runtime = {k: defaults[k] for k, i in spec.items() if not i.structural}
    alt = dict(runtime, **PARAM_ALT_BINDINGS[qname])
    dated = any(isinstance(v, int) for v in alt.values())
    third = {k: (v - 61 if isinstance(v, int) else v) if dated else v + 1.0
             for k, v in alt.items()}
    return [runtime, alt, third]


def param_query(db, qname: str, device="cpu") -> CompiledQuery:
    """The template with its structural bindings substituted, staged at
    opt-pallas with its default runtime bindings."""
    build, defaults = PARAM_QUERIES[qname]
    plan = build()
    spec = plan_params(plan)
    plan = bind_plan(plan, {k: defaults[k] for k, i in spec.items()
                            if i.structural})
    return CompiledQuery(plan, db, preset("opt-pallas"),
                         params=three_bindings(qname)[0], device=device)


def full_pass(bindings: list[dict], shift: int) -> list[dict]:
    """A full pass's bindings: the three in turn, from the `shift`th."""
    return [bindings[(i + shift) % len(bindings)] for i in range(FULL)]


def eager_pass(cq, bl: list) -> list:
    """The pass through `bind_many` and the eager vmapped walk."""
    return cq._settle(bl, [cq.execute_many(cq.bind_many(bl))])


@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_a_full_pass_on_the_cpu_never_captures(pdb, qname):
    cq = param_query(pdb, qname)
    bl = full_pass(three_bindings(qname), 0)
    want = eager_pass(cq, bl)
    got = cq.run_many(bl)
    assert cq._pass_graph is None and cq.pass_capture_error is None
    assert cq.n_pass_replays == 0 and not cq._pass_lock.locked()
    assert cq.n_executions == 2
    for g, w in zip(got, want):
        _bits(g, w)


@pytest.mark.parametrize("n,shards,device,twin,want", [
    (FULL, 1, "cuda", False, True),
    (FULL, 1, torch.device("cuda", 0), False, True),
    (FULL - 1, 1, "cuda", False, False),
    (FULL + 1, 1, "cuda", False, False),
    (50, 1, "cuda", False, False),             # each pass of 100
    (compile_mod.BATCH_MIN, 1, "cuda", False, False),
    (FULL, 2, "cuda", False, False),
    (FULL, 4, "cuda", False, False),
    (FULL, 1, "cpu", False, False),
    (FULL, 1, torch.device("cpu"), False, False),
    (FULL, 1, "cuda", True, False),
])
def test_which_passes_replay(n, shards, device, twin, want):
    assert compile_mod.replays_pass(n, shards, device, twin) is want


def test_only_the_overflow_twin_is_measure_only(pdb):
    """The twin is the query `_pass_replay` hands `replays_pass` as one:
    its settings measure, its parent's compact."""
    cq = param_query(pdb, "q3")
    assert cq.compaction_points and not cq.settings.compact_measure_only
    twin = cq._fallback_query()
    assert twin.settings.compact_measure_only
    assert twin is cq._fallback_query()


@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_the_pass_over_one_fixed_buffer_gives_bind_many_answers(pdb, qname):
    """One `PassGraph`'s buffer, written with two sets of bindings in
    turn, feeds the eager vmapped walk as a capture runs it: each time
    the answers of `bind_many`'s pass, bit for bit."""
    cq = param_query(pdb, qname)
    g = graphs.PassGraph(cq.param_spec, FULL, cq.device)
    assert set(g.params) == {f"param/{n}" for n in cq.param_spec}
    for t in g.params.values():
        assert t.shape == (FULL,)
        assert t.untyped_storage().data_ptr() \
            == g.buf.dev.untyped_storage().data_ptr()
    bindings = three_bindings(qname)
    for shift in (0, 1):
        bl = full_pass(bindings, shift)
        g.buf.write(bl)
        g.buf.send()
        for n, dt in cq.param_spec.items():
            assert g.params[f"param/{n}"].numpy().tobytes() \
                == np.asarray([b[n] for b in bl], dtype=dt).tobytes()
        got = cq._settle(bl, [cq.execute_many(g.params)])
        for a, b in zip(got, eager_pass(cq, bl)):
            _bits(a, b)


@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_the_scalar_walks_buffer_holds_one_binding(pdb, qname):
    """The scalar walk's graph keeps its one binding in the same kind of
    buffer: 0-d views of it, and the binding's host scalars handed back
    as `CompiledQuery.bind` makes them."""
    spec = param_query(pdb, qname).param_spec
    g = graphs.WalkGraph(spec, "cpu")
    assert set(g.params) == set(spec)
    for b in three_bindings(qname):
        host = g.bind(b)
        g.buf.send()
        for n, dt in spec.items():
            want = np.asarray(b[n], dtype=dt)
            assert host[n] == want.item()
            assert type(host[n]) is type(want.item())
            assert g.params[n].shape == ()
            assert g.params[n].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_bind_many_fills_one_buffer_of_the_same_kind(pdb, qname):
    """`bind_many`'s inputs are the (N,) views of one `ParamBuffer`, as a
    captured pass's are: every binding's value at its dtype, and on the
    CPU the host bytes themselves (nothing copied)."""
    cq = param_query(pdb, qname)
    bl = full_pass(three_bindings(qname), 1)[:FULL - 1]
    got = cq.bind_many(bl)
    g = graphs.ParamBuffer(cq.param_spec, len(bl), cq.device)
    assert list(got) == list(g.inputs())
    ptrs = {t.untyped_storage().data_ptr() for t in got.values()}
    assert len(ptrs) == 1
    for n, dt in cq.param_spec.items():
        t = got[f"param/{n}"]
        assert t.shape == (len(bl),) and str(t.dtype) == f"torch.{dt}"
        assert t.numpy().tobytes() \
            == np.asarray([b[n] for b in bl], dtype=dt).tobytes()


@pytest.mark.parametrize("module", ["compact", "filter_agg", "dense_agg"])
def test_a_capture_reads_every_kernel_modules_launches(module):
    """The counters a capture reads to record its graph's launches
    (`PassGraph.launches`) are each kernel module's own `launches`."""
    import importlib

    from repro_torch.kernels import build

    launches = importlib.import_module(f"repro_torch.kernels.{module}") \
        .launches
    got = graphs._launch_counts()
    assert {k: got[k] for k in launches} == launches
    name = next(iter(launches))
    build.bump(launches, name)
    try:
        assert graphs._launch_counts()[name] == got[name] + 1
    finally:
        build.bump(launches, name, -1)


@pytest.mark.parametrize("peak,allocated,want", [
    (50, 300, 40),          # a pass that set the peak: the peak
    (1000, 130, 30),        # an earlier peak above it: what it allocated
])
def test_a_pass_needs_the_least_of_its_two_bounds(peak, allocated, want):
    before = {"allocated_bytes.all.current": 10,
              "allocated_bytes.all.peak": 1000,
              "allocated_bytes.all.allocated": 100}
    after = {"allocated_bytes.all.current": 12,
             "allocated_bytes.all.peak": peak,
             "allocated_bytes.all.allocated": allocated}
    assert graphs.pass_need(before, after) == want


def _counted_replay(self, merged):
    """A stand-in for the graph where no card is: a full pass counts as
    replayed, and runs eagerly."""
    if len(merged) == FULL:
        self.n_pass_replays += 1
    return None


def test_pass_replays_pass_through_the_plan_cache_and_the_server(
        pdb, monkeypatch):
    monkeypatch.setattr(CompiledQuery, "_pass_replay", _counted_replay)
    plan, defaults = PARAM_QUERIES["q6"][0](), PARAM_QUERIES["q6"][1]
    bl = [dict(defaults, qty_max=10.0 + 0.25 * i) for i in range(FULL)]
    settings = preset("opt-pallas")
    cache = PlanCache(pdb, device="cpu")
    assert cache.pass_replays() == 0
    cache.execute_many(plan, settings, bl)
    assert cache.pass_replays() == 1
    cache.execute_many(plan, settings, bl[:10])
    cache.execute_many(plan, settings, bl + bl)     # two full passes
    assert cache.pass_replays() == 3
    cq, _ = cache.get(plan, settings, bl[0])
    assert cq.n_pass_replays == 3
    with QueryServer(pdb, settings, device="cpu", window_s=3600.0) as srv:
        assert srv.max_batch == FULL and srv.stats.pass_replays == 0
        futs = [srv.submit(plan, b) for b in bl]
        srv.drain()
        for f in futs:
            f.result(timeout=60)
        assert srv.stats.batches == 1 and srv.stats.pass_replays == 1
        futs = [srv.submit(plan, b) for b in bl[:5]]
        srv.drain()
        for f in futs:
            f.result(timeout=60)
        assert srv.stats.batches == 2 and srv.stats.pass_replays == 1
        assert srv.cache.pass_replays() == 1
