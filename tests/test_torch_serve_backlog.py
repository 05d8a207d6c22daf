"""The port's query server under a backlog, on the CPU at sf 0.01, seed 0:
a ready window goes to a worker only when one is free, so while the
workers are busy the windows fill (`ServerStats.held` counts those that
waited) and leave oldest request first across keys; with a worker idle a
lone request leaves at its window's deadline.  Deadlines, `drain` and
`close` (its grace too) still resolve every held request.  The six
templates answer through the server as `CompiledQuery.run` and the
port's Volcano do.  The plan cache's shape memo gives the key the
uncached path gives, a new key for a new string, and counts its hits in
`ServerStats.prepare_hits`.  The spans `repro.serve.submit` and
`repro.serve.group` and a stress run with many workers close the file.
Every wait takes a timeout; no assertion rests on how long a sleep
lasts."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import CompiledQuery, PlanCache, VolcanoEngine, preset
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.relational.queries import PARAM_ALT_BINDINGS, PARAM_QUERIES
from repro_torch.serve import query_server
from repro_torch.serve.admission import DeadlineExceeded
from repro_torch.serve.query_server import QueryServer
from test_torch_plan_cache import assert_matches, one_thread, pdb  # noqa: F401

SIX = sorted(PARAM_QUERIES)
T = 120                                  # seconds any wait may take


def _plan(q):
    return PARAM_QUERIES[q][0]()


def _defaults(q):
    return dict(PARAM_QUERIES[q][1])


def _alt(q):
    return dict(PARAM_QUERIES[q][1], **PARAM_ALT_BINDINGS[q])


class Gate:
    """An `exec_hook` that holds every group until `open()`, and records
    each group's plan key in the order the workers ran them."""

    def __init__(self):
        self.event = threading.Event()
        self.ran: list = []
        self.entered = threading.Event()

    def __call__(self, key, attempt):
        self.entered.set()
        assert self.event.wait(T)
        self.ran.append(key)

    def open(self):
        self.event.set()


def _server(db, gate=None, **kw):
    kw.setdefault("window_s", 3600.0)
    kw.setdefault("adaptive_window", False)
    return QueryServer(db, preset("opt"), device="cpu", exec_hook=gate, **kw)


def _key(srv, q, b):
    return srv.cache.key_for(_plan(q), srv.settings, b)


def _busy(srv, gate, q="q14"):
    """Occupy the server's one worker: a lone request whose group waits
    at the gate."""
    fut = srv.submit(srv_plans(q), _defaults(q))
    srv.flush()
    assert gate.entered.wait(T)
    return fut


_PLANS: dict = {}


def srv_plans(q):
    """One plan object a template, as a client holds them."""
    return _PLANS.setdefault(q, _plan(q))


# ---------------------------------------------------------------------------
# dispatch under a backlog
# ---------------------------------------------------------------------------

def test_busy_workers_leave_windows_full_and_count_them_held(pdb):
    """One worker held busy; 3 x max_batch requests of one key, each
    window due long before the next arrives: they leave as three full
    groups, and each waited once."""
    gate = Gate()
    srv = _server(pdb, gate, max_workers=1, max_batch=4, window_s=0.001)
    try:
        lone = _busy(srv, gate)
        plan = srv_plans("q6")
        futs = []
        for i in range(12):
            futs.append(srv.submit(plan, _alt("q6") if i % 2
                                   else _defaults("q6")))
            until = time.monotonic() + 0.002      # past the window's end
            while time.monotonic() < until:
                time.sleep(0.0005)
        assert srv.stats.held == 3 and srv.stats.batches == 0
        assert [len(w.entries) for _k, w in srv._closed_windows] == [4] * 3
        gate.open()
        got = [f.result(timeout=T) for f in futs]
        lone.result(timeout=T)
        srv.drain()
        st = srv.stats
    finally:
        gate.open()
        srv.close()
    oracle = VolcanoEngine(pdb)
    want = [oracle.execute(_plan("q6"), b)
            for b in (_defaults("q6"), _alt("q6"))]
    for i, g in enumerate(got):
        assert_matches(g, want[i % 2])
    assert st.batches == 4 and st.coalesced == 12 and st.completed == 13
    assert st.held == 3 and st.outstanding() == 0
    assert gate.ran[1:] == [_key(srv, "q6", _defaults("q6"))] * 3


def test_one_warm_group_runs_at_a_time_and_a_cold_key_takes_a_free_worker(
        pdb):
    """Two workers: while a group of a staged (warm) plan runs, a second
    warm window waits though a worker is free, and a key that still has
    to be staged takes that worker at once."""
    hold, entered, held_key = threading.Event(), threading.Event(), []

    def hook(key, attempt):
        if held_key and key == held_key[0]:
            entered.set()
            assert hold.wait(T)

    srv = _server(pdb, hook, max_workers=2)
    try:
        plan = srv_plans("q6")
        first = srv.submit(plan, _defaults("q6"))
        srv.flush()
        first.result(timeout=T)                  # q6 is staged now
        held_key.append(_key(srv, "q6", _defaults("q6")))
        running = srv.submit(plan, _defaults("q6"))
        srv.flush()
        assert entered.wait(T)
        waiting = srv.submit(plan, _alt("q6"))
        srv.flush()
        assert srv.stats.held == 1 and srv._busy == 1
        cold = srv.submit(srv_plans("q1"), _defaults("q1"))
        srv.flush()
        got = cold.result(timeout=T)
        assert not running.done() and not waiting.done()
        hold.set()
        running.result(timeout=T)
        waiting.result(timeout=T)
    finally:
        hold.set()
        srv.close()
    assert_matches(got, VolcanoEngine(pdb).execute(_plan("q1"),
                                                   _defaults("q1")))
    assert srv.stats.held == 1 and srv._busy == 0


def test_a_lone_request_leaves_at_its_deadline_with_a_worker_idle(pdb):
    srv = _server(pdb, window_s=0.05)
    try:
        t0 = time.monotonic()
        fut = srv.submit(srv_plans("q6"), _defaults("q6"))
        fut.result(timeout=T)            # no flush: the tick sends it
        waited = time.monotonic() - t0
        st = srv.stats
    finally:
        srv.close()
    assert waited >= 0.05
    assert st.batches == 1 and st.held == 0 and st.completed == 1


def test_waiting_windows_leave_oldest_request_first_across_keys(pdb):
    """q1's window opens first and stays open; q6's fills after it and
    closes; q12's opens last.  Freed, the worker takes q1, q6, q12: by
    the oldest request, not by when a window closed."""
    gate = Gate()
    srv = _server(pdb, gate, max_workers=1, max_batch=2)
    try:
        lone = _busy(srv, gate)
        f1 = srv.submit(srv_plans("q1"), _defaults("q1"))
        f6 = [srv.submit(srv_plans("q6"), _defaults("q6")) for _ in range(2)]
        f12 = srv.submit(srv_plans("q12"), _defaults("q12"))
        assert [_k for _k, _w in srv._closed_windows] == [
            _key(srv, "q6", _defaults("q6"))]
        srv.flush()
        assert srv.stats.held == 3
        gate.open()
        for f in [lone, f1, f12] + f6:
            f.result(timeout=T)
        order = gate.ran[1:]
    finally:
        gate.open()
        srv.close()
    assert order == [_key(srv, q, _defaults(q)) for q in ("q1", "q6", "q12")]


def test_a_request_past_its_deadline_while_its_window_waits_fails_alone(
        pdb):
    gate = Gate()
    srv = _server(pdb, gate, max_workers=1)
    try:
        lone = _busy(srv, gate)
        dead = srv.submit(srv_plans("q6"), _defaults("q6"), timeout_s=0.05)
        live = srv.submit(srv_plans("q6"), _alt("q6"))
        srv.flush()
        until = time.monotonic() + 0.05
        while time.monotonic() <= until:
            time.sleep(0.01)
        gate.open()
        with pytest.raises(DeadlineExceeded):
            dead.result(timeout=T)
        got = live.result(timeout=T)
        lone.result(timeout=T)
        srv.drain()
        st = srv.stats
    finally:
        gate.open()
        srv.close()
    assert_matches(got, VolcanoEngine(pdb).execute(_plan("q6"), _alt("q6")))
    assert st.deadline_misses == 1 and st.errors == 1 and st.completed == 2
    assert st.outstanding() == 0


@pytest.mark.parametrize("how", ["drain", "close"])
def test_drain_and_close_resolve_every_held_request(pdb, how):
    gate = Gate()
    srv = _server(pdb, gate, max_workers=1, max_batch=3)
    try:
        futs = [_busy(srv, gate)]
        futs += [srv.submit(srv_plans(q), _defaults(q))
                 for q in SIX for _ in range(4)]
        assert srv.stats.held > 0 and srv._windows
        threading.Timer(0.05, gate.open).start()
        getattr(srv, how)()
        assert all(f.done() for f in futs)
        assert not srv._windows and not srv._closed_windows
        for f in futs:
            f.result(timeout=0)
    finally:
        gate.open()
        srv.close()
    assert srv.stats.completed == len(futs) and srv.stats.outstanding() == 0


def test_close_grace_fails_the_held_requests(pdb):
    """The worker never frees: close()'s grace fails the requests held
    behind it, and counts them apart from errors."""
    gate = Gate()
    srv = _server(pdb, gate, max_workers=1, close_timeout_s=0.05)
    try:
        futs = [_busy(srv, gate)]
        futs += [srv.submit(srv_plans(q), _defaults(q)) for q in SIX]
        srv.close()
        assert all(f.done() for f in futs)
        for f in futs:
            with pytest.raises(RuntimeError, match="grace"):
                f.result(timeout=0)
        assert srv.stats.grace_expired == len(futs)
        assert srv.stats.errors == 0 and not srv._closed_windows
    finally:
        gate.open()
        srv._pool.shutdown(wait=True)
    assert srv.stats.completed == 0 and srv.stats.outstanding() == 0


# ---------------------------------------------------------------------------
# answers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", SIX)
def test_templates_through_the_server_answer_as_run_and_volcano(pdb, q):
    """Eight requests of a template, two bindings, in one window: one
    batched pass, the answers of `CompiledQuery.run` and of the port's
    Volcano."""
    bindings = [_defaults(q), _alt(q)] * 4
    with QueryServer(pdb, preset("opt-pallas"), device="cpu",
                     window_s=3600.0) as srv:
        futs = [srv.submit(srv_plans(q), b) for b in bindings]
        srv.flush()
        got = [f.result(timeout=T) for f in futs]
    assert srv.stats.batches == 1 and srv.stats.coalesced == 8
    # the strings are the plan's: bound before staging, as the cache does
    baked = {n: bindings[0][n] for n, s in _structural(_plan(q)).items()
             if s}
    runtime = [{n: v for n, v in b.items() if n not in baked}
               for b in bindings[:2]]
    cq = CompiledQuery(bind_plan(_plan(q), baked), pdb, preset("opt-pallas"),
                       params=runtime[0], device="cpu")
    oracle = VolcanoEngine(pdb)
    for b, r, g in zip(bindings, runtime, got):
        assert_matches(g, cq.run(r))
        assert_matches(g, oracle.execute(_plan(q), b))
    for a, b in zip(got, got[2:]):
        assert_matches(a, b)


# ---------------------------------------------------------------------------
# the plan cache's shape memo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["residual", "specialize"])
@pytest.mark.parametrize("q", SIX)
def test_memoized_prepare_keys_as_the_uncached_path(pdb, q, mode):
    cache = PlanCache(pdb, device="cpu")
    settings = preset("opt-pallas")
    plan, owned = _plan(q), None
    for i, b in enumerate((_defaults(q), _alt(q), _defaults(q))):
        cold = cache._prepare(_plan(q), settings, b, mode)   # a new object
        got = cache._prepare(plan, settings, b, mode)
        assert not cold.memo_hit
        # residual: one memo entry serves every runtime binding;
        # specialize: each binding is an entry of its own
        assert got.memo_hit == (i > 0 and (mode == "residual" or i == 2))
        assert got[0] == cold[0] and got[2] == cold[2]
        assert repr(got[1]) == repr(cold[1])
        if got.memo_hit:
            # the memo's plan is shared: never handed out for mutation
            assert got[3] is False and got[1] is not owned
        else:
            assert got[3] == cold[3]
            owned = got[1] if got[3] else None
    changed = [n for n, s in _structural(plan).items() if s]
    if changed:
        other = dict(_defaults(q), **{changed[0]: _other(
            _defaults(q)[changed[0]])})
        moved = cache._prepare(plan, settings, other, mode)
        assert not moved.memo_hit
        assert moved[0] != cache._prepare(plan, settings, _defaults(q),
                                          mode)[0]
        assert moved[0] == cache._prepare(_plan(q), settings, other,
                                          mode)[0]
    cache.close()


def _structural(plan) -> dict:
    return {n: i.structural for n, i in plan_params(plan).items()}


def _other(value):
    return value + "X" if isinstance(value, str) else value + 1


def test_memo_answers_follow_a_replan_of_the_shape(pdb):
    """A re-plan or shrink drops the shape's capacity signature: a memo
    hit then keys with the new capacities, as the uncached path does."""
    cache = PlanCache(pdb, device="cpu")
    settings = preset("opt-pallas")
    plan = _plan("q12")
    first = cache._prepare(plan, settings, _defaults("q12"), "residual")
    base = first[0][:-1]
    assert first[0][-1] != ()
    with cache._lock:
        memo = cache._caps_memo[base]
        cache._caps_memo[base] = ((1,) * len(memo[0]),) + memo[1:]
    hit = cache._prepare(plan, settings, _defaults("q12"), "residual")
    cold = cache._prepare(_plan("q12"), settings, _defaults("q12"),
                          "residual")
    assert hit.memo_hit and hit[0] == cold[0] != first[0]
    cache.close()


def test_a_repeat_request_counts_in_prepare_hits(pdb):
    with QueryServer(pdb, preset("opt"), device="cpu") as srv:
        plan = srv_plans("q12")
        futs = [srv.submit(plan, b) for b in
                (_defaults("q12"), _alt("q12"), _defaults("q12"))]
        futs.append(srv.submit(_plan("q12"), _defaults("q12")))
        other = dict(_defaults("q12"), mode1="AIR")
        futs.append(srv.submit(plan, other))
        for f in futs:
            f.result(timeout=T)
        assert srv.stats.prepare_hits == 2
        assert srv.cache.stats.compiles == 2


# ---------------------------------------------------------------------------
# spans, and a stress run
# ---------------------------------------------------------------------------

def test_submit_span_nests_in_the_senders_request_span(pdb):
    with QueryServer(pdb, preset("opt"), device="cpu") as srv:
        srv.submit(srv_plans("q6"), _defaults("q6")).result(timeout=T)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("bench.request.q6"):
                fut = srv.submit(srv_plans("q6"), _defaults("q6"))
        fut.result(timeout=T)
    events = list(prof.events())
    outer = [e for e in events if e.name == "bench.request.q6"]
    inner = [e for e in events if e.name == "repro.serve.submit"]
    assert len(outer) == 1 and len(inner) == 1
    o, i = outer[0], inner[0]
    assert i.thread == o.thread
    assert o.time_range.start <= i.time_range.start \
        and i.time_range.end <= o.time_range.end


def test_group_span_in_the_worker_and_submit_span_in_the_sender(pdb,
                                                                monkeypatch):
    seen = []
    real = query_server.span

    def recording(name):
        seen.append((name, threading.current_thread().name))
        return real(name)

    monkeypatch.setattr(query_server, "span", recording)
    with QueryServer(pdb, preset("opt"), device="cpu") as srv:
        srv.submit(srv_plans("q6"), _defaults("q6")).result(timeout=T)
    me = threading.current_thread().name
    assert ("repro.serve.submit", me) in seen
    assert [t for n, t in seen if n == "repro.serve.group"] != []
    assert all(t.startswith("query-server") for n, t in seen
               if n == "repro.serve.group")


def test_stress_many_senders_never_pass_max_workers(pdb):
    """Eight senders against four workers with a short switch interval:
    every request answers its own binding, no more than `max_workers`
    groups ever run at once, and the counters balance."""
    running, peak, lock = [0], [0], threading.Lock()

    def hook(key, attempt):
        with lock:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        time.sleep(0.001)
        with lock:
            running[0] -= 1

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv = QueryServer(pdb, preset("opt"), device="cpu", exec_hook=hook,
                          max_workers=4, max_batch=4, window_s=0.0005,
                          budget=4096)
        results: dict = {}

        def sender(r):
            for i in range(24):
                b = _alt("q6") if (r + i) % 2 else _defaults("q6")
                results[(r, i)] = (b, srv.submit(srv_plans("q6"), b))

        threads = [threading.Thread(target=sender, args=(r,))
                   for r in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
        assert not any(t.is_alive() for t in threads)
        srv.drain()
        srv.close()
    finally:
        sys.setswitchinterval(before)
    oracle = VolcanoEngine(pdb)
    want = {k: oracle.execute(_plan("q6"), b)
            for k, b in (("d", _defaults("q6")), ("a", _alt("q6")))}
    for (r, i), (b, f) in results.items():
        got = f.result(timeout=0)
        assert np.allclose(got["revenue"], want[
            "a" if b == _alt("q6") else "d"]["revenue"], rtol=2e-3)
    st = srv.stats
    assert 1 <= peak[0] <= 4 and srv._busy == 0
    assert st.completed == 8 * 24 and st.outstanding() == 0
