"""The scalar staged walk replayed as CUDA graphs (`core/graphs.py`), on
the card, at TPC-H SF 1, seed 0.

Run on a machine with an NVIDIA card and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_graph_cuda.py

Without CUDA every test here skips (the decision is taken inside the
`cuda` fixture, never at import).  Each replayed `run()` is held to the
eager walk of the same query (`execute` and `_settle`), bit for bit
wherever the eager walks agree bit for bit; where they do not (a float
sum PyTorch adds with atomics, at `opt`), every float within 1e-4 of
the eager walk's (two eager walks of q1 at `opt` differ by 1.3e-5).
The engine's entry points are counted as they are called (`ops.calls`)
and their kernels as they launch (each kernel module's `launches`): a
replayed run moves them as an eager run does, but for the large-domain
aggregation's entry point, whose kernel the graph holds."""
import importlib
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, graphs, preset
from repro_torch.core.backend import TorchBackend
from repro_torch.core.expr import Cmp, col, lit
from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.kernels import ops
from repro_torch.relational import Database
from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                            PARAM_QUERIES, QUERIES)

pytestmark = pytest.mark.cuda

# eager walks drawn, at most, to see an eager walk's float bits vary
DRAWS = 32

KERNEL_MODULES = [importlib.import_module(f"repro_torch.kernels.{m}")
                  for m in ("compact", "filter_agg", "gather_join", "topk")]


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
    torch.cuda.empty_cache()


def _eager(cq, params=None) -> dict:
    """`run(params)` through the eager walk: `execute` and `_settle`."""
    run = cq.execute(cq.bind(params))
    return cq._settle([params], [run])[0]


def _bitwise(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _canon(res: dict) -> list:
    rows = list(zip(*[res[k].tolist() for k in res]))
    return sorted(rows, key=repr)


def _check(got: dict, eager: list, more=None) -> int:
    """`got` is the eager walk's answer `eager[0]` bit for bit, unless the
    eager walk's own bits vary between its runs (a float sum PyTorch adds
    with atomics, at `opt`, and in q3's revenue at `opt-pallas`): then
    every float within 1e-4 of it, and the rest equal (rows as a set,
    since a float sort key may tie differently).  Where `got` differs
    from eager walks that all agree, up to DRAWS more are drawn (`more`)
    and added to `eager` until one differs.  Returns the walks drawn."""
    if _bitwise(got, eager[0]):
        return 0
    drawn = 0
    while all(_bitwise(e, eager[0]) for e in eager[1:]):
        assert more is not None and drawn < DRAWS, \
            "the replay's bits differ from eager walks that agree bit for bit"
        eager.append(more())
        drawn += 1
    assert list(got) == list(eager[0])
    for g, w in zip(_canon(got), _canon(eager[0])):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-4, abs=1e-5)
            else:
                assert x == y
    return drawn


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


def _param_query(db, qname, rung="opt-pallas"):
    build, defaults = PARAM_QUERIES[qname]
    plan = build()
    spec = plan_params(plan)
    runtime = {k: defaults[k] for k, i in spec.items() if not i.structural}
    plan = bind_plan(plan, {k: defaults[k] for k, i in spec.items()
                            if i.structural})
    return CompiledQuery(plan, db, preset(rung), params=runtime), runtime


@pytest.mark.parametrize("rung", ["opt-pallas", "opt"])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_replay_gives_the_eager_walks_answer(db, qname, rung):
    cq = CompiledQuery(QUERIES[qname](), db, preset(rung))
    cq.compile()
    assert cq.graph_segments >= 1, cq.capture_error
    assert cq.graph_segments == len(cq._graph.calls) + 1
    eager = [_eager(cq) for _ in range(4)]
    replays = cq.n_replays
    eager_calls = _delta(lambda: _eager(cq))
    replay_calls = _delta(cq.run)
    assert cq.n_replays == replays + 1
    # the same entry points called and kernels launched, once a run each,
    # but for the large-domain aggregation: captured inside a segment, a
    # replay launches it without calling its entry point
    assert replay_calls == {k: v for k, v in eager_calls.items()
                            if k != ("ops", "dense_agg")}
    if rung == "opt":
        assert not eager_calls
    for _ in range(2):
        _check(cq.run(), eager, lambda: _eager(cq))
    assert cq.n_replays == replays + 3


@pytest.mark.parametrize("qname", sorted(PARAM_QUERIES))
def test_replay_bakes_in_no_parameter(db, qname):
    """Three bindings alternated over several runs, each the answer of an
    eager walk of the same binding."""
    cq, runtime = _param_query(db, qname)
    alt = dict(runtime, **PARAM_ALT_BINDINGS[qname])
    # the dates two months earlier; q19, which has none, a wider range
    dated = any(isinstance(v, int) for v in alt.values())
    third = {k: (v - 61 if isinstance(v, int) else v) if dated else v + 1.0
             for k, v in alt.items()}
    bindings = [runtime, alt, third]
    cq.compile()
    assert cq.graph_segments >= 2, cq.capture_error
    want = [[_eager(cq, b) for _ in range(4)] for b in bindings]
    assert not _bitwise(want[0][0], want[1][0])
    for i in range(7):
        b = bindings[i % 3]
        _check(cq.run(b), want[i % 3], lambda: _eager(cq, b))
    assert cq.n_replays == 7


def test_a_run_that_finds_the_replay_busy_takes_the_eager_walk(db):
    """Four threads on one query, the interpreter switching threads often:
    whichever finds the lock held walks eagerly, every answer is right,
    and every run is counted once."""
    cq, runtime = _param_query(db, "q12")
    alt = dict(runtime, **PARAM_ALT_BINDINGS["q12"])
    cq.compile()
    assert cq.graph_segments >= 2, cq.capture_error
    want = [[_eager(cq, b) for _ in range(4)] for b in (runtime, alt)]
    got = {}
    with cq._replay_lock:           # another run is replaying
        t = threading.Thread(target=lambda: got.update(busy=cq.run(alt)))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and cq.n_replays == 0
    drawn = [_check(got["busy"], want[1], lambda: _eager(cq, alt))]
    walks0, errors = cq.n_executions, []

    def client(k):
        for i in range(10):
            b = (i + k) % 2
            binding = alt if b else runtime
            try:
                drawn.append(_check(cq.run(binding), want[b],
                                    lambda: _eager(cq, binding)))
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
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert cq.n_executions == walks0 + 40 + sum(drawn[1:])
    assert 1 <= cq.n_replays <= 40


def test_a_planted_overflow_reruns_through_the_twin(db):
    """A compaction point of 64 rows under about half of lineitem's rows
    overflows on every run: the replay's counts send it to the twin."""
    sel = Select(Scan("lineitem"), Cmp("<", col("l_quantity"), lit(26.0)))
    plan = Agg(Compact(sel, 64), [], [AggSpec("s", "sum",
                                              col("l_extendedprice")),
                                      AggSpec("c", "count")])
    cq = CompiledQuery(plan, db, preset("opt-pallas"))
    cq.compile()
    assert cq.graph_segments >= 2, cq.capture_error
    want = _eager(cq)
    assert cq.n_overflows == 1
    got = cq.run()
    assert cq.n_replays == 1 and cq.n_overflows == 2
    assert _bitwise(got, want)
    whole = CompiledQuery(Agg(sel, [], [AggSpec("s", "sum",
                                                col("l_extendedprice")),
                                        AggSpec("c", "count")]),
                          db, preset("opt-pallas")).run()
    assert int(got["c"][0]) == int(whole["c"][0]) > 64


def test_a_capture_that_raises_leaves_the_eager_walk(db, monkeypatch):
    """A synchronisation hidden in the walk makes the capture raise: the
    query is counted, keeps the eager walk, and the card works on."""
    take = TorchBackend.take

    def synced(arr, idx):
        torch.cuda.synchronize()
        return take(arr, idx)

    cq = CompiledQuery(QUERIES["q3"](), db, preset("opt-pallas"))
    failures = graphs.FAILURES
    with monkeypatch.context() as m:
        m.setattr(TorchBackend, "take", staticmethod(synced))
        cq.compile()
    assert cq.graph_segments == 0 and cq.capture_error
    assert graphs.FAILURES == failures + 1
    _check(cq.run(), [_eager(cq) for _ in range(4)], lambda: _eager(cq))
    assert cq.n_replays == 0
    # a capture after the failed one still replays
    other = CompiledQuery(QUERIES["q6"](), db, preset("opt-pallas"))
    other.compile()
    assert other.graph_segments >= 1, other.capture_error
    _check(other.run(), [_eager(other) for _ in range(4)],
           lambda: _eager(other))
    assert other.n_replays == 1
    assert np.isfinite(other.run()["revenue"]).all()
