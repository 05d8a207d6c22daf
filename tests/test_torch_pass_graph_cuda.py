"""A full bind-many pass replayed as one CUDA graph (`core/graphs.py`'s
`PassGraph`), on the card, at TPC-H SF 1, seed 0.

Run on a machine with an NVIDIA card and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_pass_graph_cuda.py

Without CUDA every test here skips (the decision is taken inside the
`cuda` fixture, never at import).  Each replayed pass of 64 bindings is
held to the eager vmapped pass of the same bindings (`bind_many`,
`execute_many` and `_settle`), slot by slot, bit for bit wherever the
eager passes agree bit for bit; where they do not (a float sum added
with atomics), every float within 1e-4 of the eager pass's.  The
engine's entry points are counted as they are called (`ops.calls`) and
their kernels as they launch (each kernel module's `launches`): a replay
moves none of them, and the graph records the eager pass's launches.
Passes of any other size, a pass that finds the graph's lock held, a
query whose capture raised and one whose graph finds no room on the
card stay eager; the
report service of the benchmark's `reports-backlog` cell replays every
full group once it is set up."""
import gc
import importlib
import sys
import threading
import time

import pytest
import torch

from repro_torch.core import CompiledQuery, PlanCache, graphs, preset
from repro_torch.core import compile as compile_mod
from repro_torch.core.backend import TorchBackend
from repro_torch.core.expr import Cmp, Param, col
from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select
from repro_torch.kernels import ops
from repro_torch.relational import Database
from repro_torch.relational.queries import PARAM_QUERIES
from repro_torch.serve.query_server import QueryServer
from test_torch_pass_graph import (eager_pass, full_pass, param_query,
                                   three_bindings)

pytestmark = pytest.mark.cuda

FULL = compile_mod.BATCH_MAX
# eager passes drawn, at most, to see an eager pass's float bits vary
DRAWS = 8

KERNEL_MODULES = [importlib.import_module(f"repro_torch.kernels.{m}")
                  for m in ("compact", "filter_agg", "dense_agg")]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def db(cuda):
    return Database.tpch(sf=1.0, seed=0)


@pytest.fixture(autouse=True)
def free_the_pools():
    yield
    gc.collect()            # queries in cycles hold their graphs' pools
    torch.cuda.empty_cache()


def _bitwise(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _canon(res: dict) -> list:
    rows = list(zip(*[res[k].tolist() for k in res]))
    return sorted(rows, key=repr)


def _check(got: list, eager: list, more) -> None:
    """The pass `got` is the eager pass `eager[0]` slot by slot, bit for
    bit, unless the eager pass's own bits vary between its runs: then
    every float within 1e-4 of it, and the rest equal (rows as a set).
    Where `got` differs from eager passes that all agree, up to DRAWS
    more are drawn (`more`) and added to `eager` until one differs."""
    assert len(got) == len(eager[0])
    if all(_bitwise(g, w) for g, w in zip(got, eager[0])):
        return
    drawn = 0
    while all(_bitwise(a, b) for e in eager[1:]
              for a, b in zip(e, eager[0])):
        assert drawn < DRAWS, "the replay's bits differ from eager " \
            "passes that agree bit for bit"
        eager.append(more())
        drawn += 1
    for g, w in zip(got, eager[0]):
        assert list(g) == list(w)
        for x_row, y_row in zip(_canon(g), _canon(w)):
            for x, y in zip(x_row, y_row):
                if isinstance(y, float):
                    assert x == pytest.approx(y, rel=1e-4, abs=1e-5)
                else:
                    assert x == y


def _counters() -> dict:
    out = {("ops", k): v for k, v in ops.calls.items()}
    for m in KERNEL_MODULES:
        out.update({(m.__name__, k): v for k, v in m.launches.items()})
    return out


def _delta(fn) -> dict:
    before = _counters()
    fn()
    after = _counters()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _compiled(db, qname: str) -> CompiledQuery:
    cq = param_query(db, qname, device=None)
    cq.compile()
    return cq


@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_a_full_pass_replays_the_eager_pass(db, qname):
    """The first full pass captures and replays, the next ones replay:
    two sets of bindings alternated, each the eager pass's answers, and
    a replay calls no entry point and launches nothing the counters
    see; the kernels recorded into the graph are the eager pass's."""
    cq = _compiled(db, qname)
    bindings = three_bindings(qname)
    sets = [full_pass(bindings, 0), full_pass(bindings, 1)]
    eager = [[eager_pass(cq, bl) for _ in range(2)] for bl in sets]
    eager_calls = _delta(lambda: eager_pass(cq, sets[0]))
    assert eager_calls
    assert cq._pass_graph is None and cq.n_pass_replays == 0
    _check(cq.run_many(sets[0]), eager[0],
           lambda: eager_pass(cq, sets[0]))
    assert cq._pass_graph is not None, cq.pass_capture_error
    assert cq.n_pass_replays == 1
    assert cq._pass_graph.launches == {
        k: v for (m, k), v in eager_calls.items() if m != "ops"}
    for i in (1, 0, 1):
        replayed = {}
        assert _delta(lambda: replayed.update(
            got=cq.run_many(sets[i]))) == {}
        _check(replayed["got"], eager[i], lambda: eager_pass(cq, sets[i]))
    assert cq.n_pass_replays == 4 and not cq._pass_lock.locked()
    assert cq.pass_capture_error is None


def _overflow_plan():
    """count and sum over `l_quantity < qmax` squeezed through a
    hand-planted 64-row compaction point: a binding's qmax decides
    whether its slot overflows."""
    sel = Select(Scan("lineitem"),
                 Cmp("<", col("l_quantity"), Param("qmax", "float32")))
    return Agg(Compact(sel, 64), [],
               [AggSpec("s", "sum", col("l_extendedprice")),
                AggSpec("c", "count")])


def test_a_planted_overflow_in_slot_17_reruns_through_the_twin(db):
    lo, hi = {"qmax": 1.0}, {"qmax": 26.0}     # no row; half of lineitem
    cq = CompiledQuery(_overflow_plan(), db, preset("opt-pallas"),
                       params=lo)
    cq.compile()
    bl = [hi if i == 17 else lo for i in range(FULL)]
    got = cq.run_many(bl)
    assert cq.n_pass_replays == 1 and cq.n_overflows == 1
    assert cq.n_executions == 1
    twin = cq._fallback
    assert twin is not None and twin.settings.compact_measure_only
    assert twin.n_executions == 1
    assert twin._pass_graph is None
    eager = [eager_pass(cq, bl) for _ in range(2)]
    assert cq.n_overflows == 3 and twin.n_executions == 3
    _check(got, eager, lambda: eager_pass(cq, bl))
    assert int(got[17]["c"][0]) > 64 and int(got[0]["c"][0]) == 0


def _eager_passes(cq, bl: list) -> list:
    """`run_many(bl)` through eager passes, cut as it cuts them."""
    k = -(-len(bl) // FULL)
    cuts = [len(bl) * i // k for i in range(k + 1)]
    return [r for a, b in zip(cuts, cuts[1:])
            for r in eager_pass(cq, bl[a:b])]


@pytest.mark.parametrize("n", [FULL - 1, FULL + 1])
def test_a_pass_of_any_other_size_stays_eager(db, n):
    """63 bindings are one pass, 65 two (33 and 32) or, batched, one of
    65: none of them a graph's."""
    cq = _compiled(db, "q12")
    bindings = three_bindings("q12")
    bl = [bindings[i % 3] for i in range(n)]
    eager = [_eager_passes(cq, bl) + eager_pass(cq, bl) for _ in range(2)]
    e0 = cq.n_executions
    got = cq.run_many(bl)
    assert cq.n_executions - e0 == (1 if n < FULL else 2)
    got += cq.run_batched(bl)
    assert cq.n_pass_replays == 0 and cq._pass_graph is None
    _check(got, eager, lambda: _eager_passes(cq, bl) + eager_pass(cq, bl))


def test_a_pass_that_finds_the_lock_held_stays_eager(db):
    cq = _compiled(db, "q6")
    bl = full_pass(three_bindings("q6"), 0)
    eager = [eager_pass(cq, bl) for _ in range(2)]
    got = {}
    with cq._pass_lock:             # another pass is replaying
        t = threading.Thread(target=lambda: got.update(
            busy=cq.run_many(bl)))
        t.start()
        t.join(timeout=120)
    assert not t.is_alive()
    assert cq.n_pass_replays == 0 and cq._pass_graph is None
    _check(got["busy"], eager, lambda: eager_pass(cq, bl))
    _check(cq.run_many(bl), eager, lambda: eager_pass(cq, bl))
    assert cq.n_pass_replays == 1


def test_a_capture_that_raises_leaves_the_eager_pass(db, monkeypatch):
    """A synchronisation hidden in the walk makes the pass's capture
    raise: the query is counted, keeps the eager pass for good, and the
    card works on, its allocator giving cached memory back again."""
    take = TorchBackend.take

    def synced(arr, idx):
        torch.cuda.synchronize()
        return take(arr, idx)

    cq = _compiled(db, "q3")
    bl = full_pass(three_bindings("q3"), 0)
    eager = [eager_pass(cq, bl) for _ in range(2)]
    failures = graphs.FAILURES
    with monkeypatch.context() as m:
        m.setattr(TorchBackend, "take", staticmethod(synced))
        got = cq.run_many(bl)
    assert cq._pass_graph is None and cq.pass_capture_error
    assert graphs.FAILURES == failures + 1
    assert not cq._pass_lock.locked()
    # no capture is left underway: the allocator gives its cache back
    spare = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    del spare
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= reserved - (1 << 30)
    _check(got, eager, lambda: eager_pass(cq, bl))
    _check(cq.run_many(bl), eager, lambda: eager_pass(cq, bl))
    assert cq.n_pass_replays == 0 and graphs.FAILURES == failures + 1
    # a capture after the failed one still replays
    other = _compiled(db, "q6")
    obl = full_pass(three_bindings("q6"), 0)
    oeager = [eager_pass(other, obl) for _ in range(2)]
    _check(other.run_many(obl), oeager, lambda: eager_pass(other, obl))
    assert other.n_pass_replays == 1, other.pass_capture_error


def test_replayed_passes_are_counted_up_to_the_server(db):
    plan, defaults = PARAM_QUERIES["q14"]
    bl = [dict(defaults, **b) for b in full_pass(three_bindings("q14"), 0)]
    settings = preset("opt-pallas")
    with QueryServer(db, settings, window_s=3600.0) as srv:
        for k, n in enumerate((FULL, FULL, 5)):
            futs = [srv.submit(plan(), b) for b in bl[:n]]
            srv.drain()
            for f in futs:
                f.result(timeout=300)
            assert srv.stats.batches == k + 1
        assert srv.stats.pass_replays == 2
        assert srv.cache.pass_replays() == 2
        cq, _ = srv.cache.get(plan(), settings, bl[0])
        assert cq.n_pass_replays == 2


def test_the_report_service_replays_every_full_group(cuda, monkeypatch):
    """The benchmark's `reports-backlog` cell, set up as the benchmark
    sets it up, then its warm-up and a 2 s window: every group of a full
    pass after set-up replays, and full groups are most groups (a group
    of fewer requests, the traffic's to decide, runs the eager pass)."""
    from bench import harness, manifest

    cell = manifest.load("reports-backlog")
    seed = 3500000035
    failures = graphs.FAILURES
    _arrays, client, _setup = harness.set_up(cell, seed, cuda, None,
                                             time.monotonic())
    try:
        stats = client.server.stats
        sizes = []
        real = PlanCache.run_many

        def counted(self, cq, runtime_list):
            runtime_list = list(runtime_list)
            sizes.append(len(runtime_list))
            return real(self, cq, runtime_list)

        monkeypatch.setattr(PlanCache, "run_many", counted)
        r0, b0 = stats.pass_replays, stats.batches
        _loop, run, _peak, _peak_window = harness.measure(
            cell, client, cell.traffic, seed, 2.0, cuda)
        assert run.counters["errors"] == 0 and run.counters["completed"]
        full = sizes.count(FULL)
        assert stats.pass_replays - r0 == full
        assert stats.batches - b0 >= len(sizes) >= full > len(sizes) / 2
        assert graphs.FAILURES == failures
    finally:
        client.close()


def test_threads_sharing_one_query_count_every_pass_once(db):
    """Four threads run the same full pass of one query five times each,
    the interpreter switching threads often: whichever finds the graph
    busy runs the eager pass, every answer is right, and every pass is
    counted once, as an execution and (if it replayed) as a replay."""
    cq = _compiled(db, "q6")
    bl = full_pass(three_bindings("q6"), 0)
    eager = [eager_pass(cq, bl) for _ in range(2)]
    cq.run_many(bl)                         # the capture
    e0, r0 = cq.n_executions, cq.n_pass_replays
    errors = []

    def client(k):
        for i in range(5):
            try:
                _check(cq.run_many(bl), eager, lambda: eager_pass(cq, bl))
            except Exception as e:      # noqa: BLE001 - reported below
                errors.append((k, i, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    drawn = len(eager) - 2
    assert cq.n_executions - e0 == 20 + drawn
    assert 1 <= cq.n_pass_replays - r0 <= 20
    assert not cq._pass_lock.locked()


def test_a_pass_without_room_for_its_graph_stays_eager(db, cuda):
    """With most of the card held, a query's first full pass finds no
    room for its graph's pool beside an eager pass: it is not captured,
    it counts as a capture that raised, the query keeps the eager pass
    for good, and its answers are the eager pass's.  The card is given
    back as it was (last in the file: it moves the allocator's peak)."""
    cq = _compiled(db, "q3")
    bl = full_pass(three_bindings("q3"), 0)
    eager = [eager_pass(cq, bl) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eager.append(eager_pass(cq, bl))
    need = torch.cuda.max_memory_allocated() - before
    assert need > 1 << 30
    torch.cuda.empty_cache()
    free, _total = torch.cuda.mem_get_info()
    # room for the warm pass and the eager pass after it, not for twice
    hold = torch.empty(free - need * 3 // 2, dtype=torch.uint8,
                       device=cuda)
    failures = graphs.FAILURES
    try:
        got = cq.run_many(bl)
        assert cq._pass_graph is None and cq.n_pass_replays == 0
        assert "no room" in cq.pass_capture_error
        assert graphs.FAILURES == failures + 1
        assert not cq._pass_lock.locked()
        _check(got, eager, lambda: eager_pass(cq, bl))
        _check(cq.run_many(bl), eager, lambda: eager_pass(cq, bl))
        assert cq._pass_graph is None and graphs.FAILURES == failures + 1
    finally:
        del hold
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    back, _total = torch.cuda.mem_get_info()
    assert back > free - (1 << 30), (back, free, torch.cuda.memory_reserved(),
                                     torch.cuda.memory_allocated())
