"""Concurrent parameterized query server over the plan cache.

The analytics twin of the reference's `serve/batcher.py` engine:
requests arrive concurrently, each naming a plan + parameter bindings;
execution goes through a shared `PlanCache` so only the first request
for a plan shape pays staging (and, at `opt-pallas`, the `nvcc` builds
of its generated kernels), and *in-flight* compilations are
deduplicated — a request arriving while another request is already
compiling the same key parks on that compilation instead of starting a
second one.

Execution is *coalesced*, mirroring `batcher.py`'s tick discipline:
requests arriving within one window that share a plan key are grouped
into a single batch, executed by one `CompiledQuery.run_many` (via
`PlanCache.run_many`: from `compile.BATCH_MIN` requests one staged
walk under vmap for the whole group, each engine kernel one launch a
call site, the counts read in one copy), and their results scattered
back to the per-request futures.  A window flushes when it
fills (`max_batch`), when its deadline expires (the flusher thread's
tick), or when `flush()`/`drain()` forces it — `drain` flushes partial
windows, so no request can hang because traffic stopped mid-tick.  The
window length adapts to the observed arrival rate (an EMA of
inter-arrival gaps, the `StragglerStats` idiom): sparse traffic widens
the window to coalesce more, dense traffic narrows it toward the time a
full batch takes to arrive.

Overload hardening (docs/architecture.md §10):

  * admission control — a bounded pending budget with per-tenant
    fairness and priorities (`serve/admission.py`); a request past the
    budget raises a typed `Overloaded` at submit time instead of
    queueing unboundedly;
  * per-request deadlines — `submit(..., timeout_s=)`; a request whose
    deadline passes before its group executes fails with
    `DeadlineExceeded` (counted in `deadline_misses`) without poisoning
    the rest of the group;
  * bounded retry — a group whose execution raises a `TransientError`
    is replayed up to `max_retries` times with exponential backoff
    against the same compiled entry (restore-and-replay, mirroring
    `runtime/fault_tolerance.py`; the window's request list is the
    checkpoint and execution never mutates it);
  * a degradation ladder keyed off the admission load, expressed as
    *tier demotion* over the same `core.tiering.TierLadder` the plan
    cache promotes along (docs §11): first shed to smaller coalescing
    buckets (lower latency, less batching), then demote the execution
    tier to the ladder's interpret rung (mask-only settings — same
    results, no compaction machinery, a distinct cheaper plan-cache
    entry), and only then reject;
  * chaos seams — `compile_hook(key)` fires in the owning group just
    before a cold compile, `exec_hook(key, attempt)` before every
    execution attempt; `serve/chaos.py` drives both from a seeded
    schedule.

Tiered serving (opt-in, `tiered=True`; docs §11): a cold plan shape is
served immediately from the best *ready* execution tier — the Volcano
oracle on request 1 — while the cache's background promoter compiles the
target tier and hot-swaps it in; no request ever blocks on staging or
`nvcc`.  `warm_state_path` persists the compaction feedback store and
warm metadata on `close()` and restores them at construction, so a
restarted server answers request 1 at the pre-restart converged
capacities (pair with `persist.enable_compilation_cache` to also reuse
the kernel builds themselves).

Device: the cache's entries live on `device` (CUDA unless the caller
asks for the CPU; without CUDA the default raises).  Pool threads launch
on the device's current stream, the default one, where the resident
inputs were copied: giving a worker its own stream would need events
between the copy and the reads.

Two driving styles:

  * `submit()` returns a `concurrent.futures.Future`; the flusher groups
    and a thread pool overlaps compilations and batch executions.
  * `serve_batch()` submits a list of requests, flushes, and collects in
    order — the deterministic form the tests exercise.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import (Future, InvalidStateError,
                                ThreadPoolExecutor, wait)
from typing import Callable, Optional

from repro_torch.core import ir, tiering
from repro_torch.core.passes.pipeline import Settings, preset
from repro_torch.core.plan_cache import PlanCache
from repro_torch.serve.admission import (AdmissionController, DeadlineExceeded,
                                   LatencyHistogram, Overloaded, RateEMA,
                                   TransientError)

_UNSET = object()


@dataclasses.dataclass
class ServerStats:
    submitted: int = 0         # every submit() that passed the closed check
    completed: int = 0         # futures delivered a result
    errors: int = 0            # futures delivered an exception (incl.
    #                            deadline misses; NOT grace expiries)
    rejected: int = 0          # admission rejections (typed Overloaded)
    cancelled: int = 0         # futures the client cancelled while pending
    grace_expired: int = 0     # futures failed because close()'s grace
    #                            period ran out (kept out of `errors` so
    #                            shutdown debt is visible on its own)
    shared_compiles: int = 0   # groups that parked on an in-flight compile
    batches: int = 0           # dispatched groups (including singletons)
    coalesced: int = 0         # requests that shared a run_many
    # degradation ladder + fault handling
    shed_batch: int = 0        # requests served under shrunken windows
    shed_plan: int = 0         # requests served via degraded mask-only plans
    retries: int = 0           # group replays after a TransientError
    deadline_misses: int = 0   # requests failed with DeadlineExceeded
    # tiered serving: dispatched groups by the execution tier that
    # actually served them (empty unless tiered=True)
    tier_served: dict = dataclasses.field(default_factory=dict)
    # adaptive capacity feedback, passed through from the shared
    # PlanCache after each group (re-plans from observed overflows,
    # shrinks from sustained underuse — see CacheStats)
    replans: int = 0
    shrinks: int = 0
    # completion latency (submit -> result) of successful requests
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    def outstanding(self) -> int:
        """Requests admitted but not yet resolved.  Zero once the server
        is closed: every submitted request ends in exactly one of
        completed / errors / rejected / cancelled / grace_expired."""
        return (self.submitted - self.completed - self.errors
                - self.rejected - self.cancelled - self.grace_expired)


@dataclasses.dataclass
class _Entry:
    """One admitted request inside a window."""
    runtime: dict                    # runtime bindings
    fut: Future
    deadline: Optional[float]        # monotonic; None = no deadline
    tenant: Optional[str]
    t_submit: float                  # monotonic submit time (latency)


@dataclasses.dataclass
class _Window:
    """One coalescing window: all pending requests for one plan key."""
    plan: ir.Plan                    # prepared (structurally bound) plan
    owned: bool                      # plan is a private copy
    deadline: float                  # monotonic flush time
    settings: Settings               # full or degraded (ladder rung 2)
    max_batch: int                   # full or shrunken (ladder rung 1)
    entries: list = dataclasses.field(default_factory=list)  # [_Entry]


class QueryServer:
    def __init__(self, db, settings: Optional[Settings] = None, *,
                 cache: Optional[PlanCache] = None, max_workers: int = 4,
                 compile_hook: Optional[Callable] = None,
                 exec_hook: Optional[Callable] = None,
                 window_s: float = 0.0025, max_batch: int = 64,
                 adaptive_window: bool = True,
                 budget: int = 256, tenant_frac: float = 0.5,
                 priority_headroom: Optional[int] = None,
                 degradation: bool = True,
                 shed_batch_load: float = 0.5, shed_plan_load: float = 0.75,
                 default_timeout_s: Optional[float] = None,
                 max_retries: int = 1, retry_backoff_s: float = 0.02,
                 close_timeout_s: float = 60.0,
                 tiered: bool = False,
                 warm_state_path: Optional[str] = None,
                 device=None):
        self.db = db
        self.settings = settings or preset("opt")
        self.tiered = tiered
        self.warm_state_path = warm_state_path
        self.cache = cache or PlanCache(db, tiered=tiered, device=device)
        self.stats = ServerStats()
        self.compile_hook = compile_hook   # chaos seam: pre-cold-compile
        self.exec_hook = exec_hook         # chaos seam: pre-execution
        self.window_s = window_s
        self.max_batch = max_batch
        self.adaptive_window = adaptive_window
        self.admission = AdmissionController(budget, tenant_frac,
                                             priority_headroom)
        self.degradation = degradation
        self.shed_batch_load = shed_batch_load
        self.shed_plan_load = shed_plan_load
        self.default_timeout_s = default_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.close_timeout_s = close_timeout_s
        # the SAME ladder object the plan cache promotes along: overload
        # demotes the serving tier one rung below the target (the
        # interpret/mask-only rung for compiled targets), so degradation
        # and promotion are two directions over one abstraction.
        self.ladder = tiering.TierLadder(self.settings)
        if self.ladder.target.rank > tiering.INTERPRET.rank:
            self._degraded_settings = \
                self.ladder.settings_for(tiering.INTERPRET)
        else:
            # interpret-or-lower target: there is no cheaper tier worth
            # demoting to, rung 2 degenerates to the base settings
            self._degraded_settings = self.settings
        if warm_state_path is not None:
            self.cache.load(warm_state_path)
        self._arrivals = RateEMA()
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="query-server")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._windows: dict[tuple, _Window] = {}
        self._inflight: dict[tuple, threading.Event] = {}
        self._futures: list[Future] = []
        self._closed = False
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="query-server-flusher",
                                         daemon=True)
        self._flusher.start()

    # -- client API -----------------------------------------------------------
    def submit(self, plan: ir.Plan, bindings: Optional[dict] = None,
               mode: str = "residual", *, tenant: Optional[str] = None,
               priority: int = 0, timeout_s=_UNSET) -> Future:
        if self._closed:
            raise RuntimeError("server is closed")
        now = time.monotonic()
        timeout = self.default_timeout_s if timeout_s is _UNSET else timeout_s
        deadline = None if timeout is None else now + timeout
        # degradation rung from the load *before* this request admits —
        # it decides the settings, which decide the plan key, so it must
        # be read before _prepare (a concurrent submit may shift the load
        # by one; the rungs are heuristics, not invariants).
        level = self._level()
        settings = self._degraded_settings if level >= 2 else self.settings
        # one canonicalization per request: compile-time params are baked
        # into the plan here, so the key both dedups compilation and
        # partitions the coalescing windows by plan structure.  Binding
        # errors (missing params) raise here, before any accounting.
        key, prepared, runtime, owned = self.cache._prepare(
            plan, settings, bindings, mode)
        fut: Future = Future()
        entry = _Entry(runtime, fut, deadline, tenant, now)
        full = None
        with self._cv:
            if self._closed:   # re-check under the lock: close() races us
                raise RuntimeError("server is closed")
            self.stats.submitted += 1
            self._arrivals.observe(now)
            try:
                self.admission.admit(tenant, priority)
            except Overloaded:
                self.stats.rejected += 1
                raise
            if level >= 2:
                self.stats.shed_plan += 1
            elif level >= 1:
                self.stats.shed_batch += 1
            # completed futures (and their pinned results) don't accumulate
            self._futures = [f for f in self._futures if not f.done()]
            self._futures.append(fut)
            w = self._windows.get(key)
            if w is None:
                w = _Window(prepared, owned, now + self._window_len(level),
                            settings, self._batch_cap(level))
                self._windows[key] = w
            w.entries.append(entry)
            if len(w.entries) >= w.max_batch:
                full = self._windows.pop(key)
            else:
                self._cv.notify()
        # the admission slot frees on ANY resolution (result, error,
        # cancel, close); successful completions also feed the latency
        # histogram here, since every resolution path runs the callbacks
        fut.add_done_callback(self._release_cb(tenant, now))
        if level >= 2:
            self.cache.note_degraded()
        if full is not None:
            self._dispatch(key, full)
        return fut

    def serve_batch(self, requests) -> list:
        """Submit (plan, bindings) pairs together, flush, drain in order."""
        futs = [self.submit(plan, bindings) for plan, bindings in requests]
        self.flush()
        return [f.result() for f in futs]

    def flush(self) -> None:
        """Dispatch every open window now, full or not (a forced tick)."""
        with self._cv:
            popped = list(self._windows.items())
            self._windows.clear()
        for key, w in popped:
            self._dispatch(key, w)

    def prewarm(self, requests) -> int:
        """Eagerly warm the cache for (plan, bindings) shapes a previous
        process knew to be hot (restored via `warm_state_path`); returns
        the number of shapes warmed.  Tiered servers kick the background
        promoter and return immediately; non-tiered servers compile
        synchronously.  Shapes with no warm hint are skipped — prewarm
        never compiles speculatively."""
        n = 0
        for plan, bindings in requests:
            if not self.cache.is_warm(plan, self.settings, bindings):
                continue
            if self.tiered:
                self.cache.get_tiered(plan, self.settings, bindings)
            else:
                self.cache.get(plan, self.settings, bindings)
            n += 1
        return n

    def drain(self) -> None:
        """Flush partial windows and wait for every outstanding request —
        traffic stopping mid-tick must never leave a future hanging."""
        self.flush()
        with self._cv:
            pending = list(self._futures)
        # wait() tolerates cancelled futures, unlike f.exception(); request
        # errors stay parked on the futures for their owners to observe.
        wait(pending)
        with self._cv:
            self._futures = [f for f in self._futures if not f.done()]

    def close(self) -> None:
        """Close the server: no new submissions, then settle every
        outstanding request — flush pending windows, wait up to
        `close_timeout_s` for their futures, and *fail* anything that
        still hasn't resolved.  A future returned by `submit()` must
        never stay pending after `close()` returns, no matter how the
        shutdown races an open window (e.g. one popped by the flusher but
        not yet dispatched when the pool goes down).  Requests failed
        because the grace period ran out are counted in
        `stats.grace_expired`, not folded into `errors`.

        Before it returns, close() joins the flusher, the pool and the
        cache's promoter (`PlanCache.close`), so no thread of the server
        is inside a CUDA call when the interpreter exits — except a
        worker still stuck when the grace period ran out, which is left
        to finish on its own: the grace period bounds close()."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self.flush()
        with self._cv:
            pending = list(self._futures)
        # bounded, unlike drain(): a stuck worker (or a window dropped by
        # a shutdown race) must not park close() forever — anything still
        # unresolved after the grace period is failed below instead of
        # waited on.
        wait(pending, timeout=self.close_timeout_s)
        expired = [f for f in pending if not f.done()]
        if expired:
            graced = cancelled = 0
            exc = RuntimeError("request unresolved after the close() "
                               f"grace period ({self.close_timeout_s}s)")
            for f in expired:
                st = self._settle(f, exc=exc)
                if st == "done":
                    graced += 1
                elif st == "cancelled":
                    cancelled += 1
            with self._lock:
                self.stats.grace_expired += graced
                self.stats.cancelled += cancelled
            # don't wait for whatever wedged those futures: a stuck
            # worker settling one of them later hits the already-resolved
            # guard and counts nothing
            self._pool.shutdown(wait=False)
        else:
            self._pool.shutdown(wait=True)
        self._flusher.join(timeout=self.close_timeout_s)
        # belt and suspenders: a window that slipped past the final flush
        # (popped by the flusher after it, or created by a racing submit)
        # would otherwise hang its owner forever — resolve it with an
        # error.
        with self._cv:
            leftovers = list(self._windows.values())
            self._windows.clear()
        exc = RuntimeError("server closed with the request unresolved")
        for w in leftovers:
            n = self._settle_entries(w.entries, exc)
            with self._lock:
                self.stats.errors += n
        with self._cv:
            unresolved = [f for f in self._futures if not f.done()]
            self._futures = []
        for f in unresolved:
            if self._settle(f, exc=exc) == "done":
                with self._lock:
                    self.stats.grace_expired += 1
        # persist warm state last, after every group has executed and fed
        # the compaction feedback store; a failed save must not turn a
        # clean shutdown into a crash (next start is simply cold).
        if self.warm_state_path is not None:
            try:
                self.cache.save(self.warm_state_path)
            except OSError:
                pass
        self.cache.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- adaptive window + degradation ladder ---------------------------------
    def _level(self) -> int:
        """Current degradation rung: 0 = full fidelity, 1 = shrunken
        coalescing buckets, 2 = degraded mask-only plans.  Rung 3
        (reject) lives in the admission controller itself."""
        if not self.degradation:
            return 0
        load = self.admission.load()
        if load >= self.shed_plan_load:
            return 2
        if load >= self.shed_batch_load:
            return 1
        return 0

    def _window_len(self, level: int) -> float:
        """Coalescing window for a new window opened now: the EMA of
        inter-arrival gaps scaled to the time a full batch takes to
        arrive, clamped to [window_s/8, window_s*4]; under overload
        (rung >= 1) quartered again — smaller buckets drain the queue in
        more, smaller dispatches."""
        w = self.window_s
        if self.adaptive_window:
            iv = self._arrivals.interval()
            if iv is not None:
                w = min(max(iv * self.max_batch, self.window_s / 8),
                        self.window_s * 4)
        if level >= 1:
            w /= 4
        return w

    def _batch_cap(self, level: int) -> int:
        return self.max_batch if level < 1 else max(1, self.max_batch // 4)

    def _release_cb(self, tenant: Optional[str], t_submit: float):
        def _done(f: Future) -> None:
            self.admission.release(tenant)
            if not f.cancelled() and f.exception() is None:
                dt = time.monotonic() - t_submit
                with self._lock:
                    self.stats.latency.observe(dt)
        return _done

    # -- coalescing tick ------------------------------------------------------
    def _flush_loop(self):
        """Flusher thread: dispatch each window when its deadline passes
        (the tick), sleeping until the next deadline otherwise."""
        while True:
            popped = []
            with self._cv:
                if self._closed and not self._windows:
                    return
                now = time.monotonic()
                due = [k for k, w in self._windows.items()
                       if w.deadline <= now]
                for k in due:
                    popped.append((k, self._windows.pop(k)))
                if not popped:
                    nxt = min((w.deadline for w in self._windows.values()),
                              default=None)
                    self._cv.wait(None if nxt is None
                                  else max(0.0, nxt - now))
                    continue
            for key, w in popped:
                self._dispatch(key, w)

    def _dispatch(self, key: tuple, window: _Window) -> None:
        try:
            self._pool.submit(self._run_group, key, window)
        except RuntimeError as e:
            # pool already shut down (a submit raced close()): fail the
            # window's requests instead of stranding their futures — and
            # never let the exception kill the flusher thread.
            n = self._settle_entries(window.entries, e)
            with self._lock:
                self.stats.errors += n

    # -- future settlement ----------------------------------------------------
    @staticmethod
    def _settle(fut: Future, result=None, exc=None) -> str:
        """Resolve one request future under the executor state protocol;
        returns 'done' (delivered), 'cancelled', or 'stale'.

        These futures are created by `submit()`, not by an executor, so a
        client `cancel()` leaves them in CANCELLED — a state
        `concurrent.futures.wait` does NOT count as complete until
        `set_running_or_notify_cancel()` advances it to
        CANCELLED_AND_NOTIFIED.  Skipping that call deadlocks `drain()`
        on any cancelled request.  'stale' covers a future some other
        path already resolved (e.g. a grace-expired future a late worker
        finally reached — CPython raises a plain RuntimeError for that
        state, not InvalidStateError)."""
        try:
            if fut.set_running_or_notify_cancel():
                if exc is not None:
                    fut.set_exception(exc)
                else:
                    fut.set_result(result)
                return "done"
            return "cancelled"
        except (InvalidStateError, RuntimeError):
            return "stale"

    def _settle_entries(self, entries: list, exc: BaseException) -> int:
        """Fail every entry's future; returns the number actually
        delivered (cancelled ones are counted in stats here, stale ones
        were already accounted by whoever resolved them)."""
        delivered = cancelled = 0
        for e in entries:
            st = self._settle(e.fut, exc=exc)
            if st == "done":
                delivered += 1
            elif st == "cancelled":
                cancelled += 1
        if cancelled:
            with self._lock:
                self.stats.cancelled += cancelled
        return delivered

    def _expire(self, entries: list) -> list:
        """Split off entries whose deadline already passed and fail them
        with DeadlineExceeded; returns the still-live entries.  An
        expired request costs its own future, never the group's."""
        now = time.monotonic()
        live = [e for e in entries
                if e.deadline is None or e.deadline > now]
        if len(live) == len(entries):
            return entries
        dead = [e for e in entries
                if not (e.deadline is None or e.deadline > now)]
        n = self._settle_entries(
            dead, DeadlineExceeded(
                "deadline passed before the request's group executed"))
        with self._lock:
            self.stats.deadline_misses += n
            self.stats.errors += n
        return live

    # -- group execution ------------------------------------------------------
    def _resolve_compiled(self, key, window: _Window, runtime: dict):
        """Compile-or-hit with in-flight dedup: parked groups re-enter
        after the owner finishes, so if the owner's compilation *failed*
        (cache still cold) one waiter becomes the new owner instead of
        every waiter compiling at once."""
        while True:
            owner, event = False, None
            with self._lock:
                event = self._inflight.get(key)
                if event is None and not self.cache.contains(key):
                    event = threading.Event()
                    self._inflight[key] = event
                    owner = True
                elif event is not None:
                    self.stats.shared_compiles += 1
            if owner:
                try:
                    if self.compile_hook is not None:
                        self.compile_hook(key)
                    return self.cache._get_prepared(
                        key, window.plan, runtime, window.owned,
                        window.settings)
                finally:
                    with self._lock:
                        self._inflight.pop(key, None)
                    event.set()
            elif event is not None:
                event.wait()   # then re-check: hit, or take ownership
            else:
                return self.cache._get_prepared(
                    key, window.plan, runtime, window.owned,
                    window.settings)

    def _run_group(self, key, window: _Window):
        entries = self._expire(window.entries)
        if not entries:
            return
        attempt = 0
        while True:
            try:
                if self.tiered:
                    # never block a request on staging: serve the
                    # best READY tier now, promotion happens off-thread
                    # (retries naturally pick up a freshly promoted tier)
                    cq = self.cache._get_tiered_prepared(
                        key, window.plan, entries[0].runtime, window.owned,
                        window.settings, compile_hook=self.compile_hook)[0]
                    with self._lock:
                        self.stats.tier_served[cq.tier_name] = \
                            self.stats.tier_served.get(cq.tier_name, 0) + 1
                else:
                    cq = self._resolve_compiled(key, window,
                                                entries[0].runtime)
                if self.exec_hook is not None:
                    self.exec_hook(key, attempt)
                runtimes = [e.runtime for e in entries]
                if len(runtimes) == 1:
                    results = [cq.run(runtimes[0])]
                    self.cache._note_compaction(cq, 1)
                else:
                    # one run_many for the whole group
                    results = self.cache.run_many(cq, runtimes)
                break
            except BaseException as e:
                if attempt < self.max_retries \
                        and isinstance(e, TransientError):
                    # bounded restore-and-replay (fault_tolerance.py's
                    # idiom): the window's request list is the checkpoint
                    # — execution never mutates it — so the replay is the
                    # same group minus anything whose deadline passed
                    # while we backed off.
                    with self._lock:
                        self.stats.retries += 1
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
                    attempt += 1
                    entries = self._expire(entries)
                    if not entries:
                        return
                    continue
                n = self._settle_entries(entries, e)
                with self._lock:
                    self.stats.errors += n
                return
        delivered = cancelled = 0
        for e, res in zip(entries, results):
            # a client may have cancelled its future while the window
            # was pending; that must not poison the rest of the group
            st = self._settle(e.fut, result=res)
            if st == "done":
                delivered += 1
            elif st == "cancelled":
                cancelled += 1
        with self._lock:
            self.stats.completed += delivered
            self.stats.cancelled += cancelled
            self.stats.batches += 1
            if len(results) > 1:
                self.stats.coalesced += len(results)
            self.stats.replans = self.cache.stats.replans
            self.stats.shrinks = self.cache.stats.shrinks
