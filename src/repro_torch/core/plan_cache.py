"""Parameterized plan cache: compile once, bind many (runtime layer).

`CompiledQuery` pays the pass pipeline, the staging walk and the copy of
its inputs to the device on every construction, and its first run at
`opt-pallas` pays `nvcc` for each generated predicate; for a query server
that cost must be amortized across executions the way Dashti et al.
amortize PL/SQL compilation.  The cache
key is

    (canonicalized plan structure, engine settings, database identity,
     planned compaction capacities)

where "canonicalized plan structure" is the repr of the *logical* plan
after compile-time parameters (string values, Limit.n) have been
substituted — so two requests for the same plan shape share one staged
program, while requests differing in a compile-time value are distinct
entries.  Runtime (numeric) parameters never enter the key: the hit path
re-binds them into the staged program (`CompiledQuery.run`), whose
kernels take them as scalar arguments of libraries already built,
dropping repeated-query latency from staging cost to bind+execute cost.

Two modes:

  residual   (default) — numeric params stay runtime inputs; one cache
             entry serves every binding.
  specialize — all params are baked in as literals (the paper's fully
             specialized program); each distinct binding is its own entry.

Tiered mode (`PlanCache(..., tiered=True)`, docs §11) changes what a
cold request costs: `get_tiered` returns the best *ready* rung of the
execution-tier ladder immediately — on a stone-cold shape that is the
Volcano oracle, constructed in microseconds — while a bounded background
thread stages the target tier, builds its kernels (`CompiledQuery.
compile`) and hot-swaps the entry.  Promotion is
deduplicated per key, and `CacheStats.tier_hits/promotions` expose the
climb.  A failed target compile is sticky.  On the CPU it falls back to
the ready tier, as the reference does; on the card every later request
of that shape raises the failure instead (`PromotionFailed`): a kernel
that does not build or launch must never be answered by the host oracle
in silence.  `save`/`load` persist the feedback store + warm metadata
(`core/persist.py`) so a restarted process re-plans nothing.

Every entry keeps its inputs resident on `device` (CUDA unless the
caller asks for the CPU; there is no fallback).  Eviction, retirement
and `close()` drop the cache's every reference to an entry, its twin and
its ladder, so the caching allocator can reuse their device memory once
callers drop theirs.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from repro_torch.core import compile as compile_mod
from repro_torch.core import ir
from repro_torch.core import persist as persist_mod
from repro_torch.core import tiering
from repro_torch.core.compile import CompiledQuery, resolve_device
from repro_torch.core.mesh import resolve_shards
from repro_torch.core.observations import Harvest
from repro_torch.core.passes.compaction import observed_bucket
from repro_torch.core.passes.param_binding import bind_plan, plan_params
from repro_torch.core.passes.pipeline import Settings, optimize
from repro_torch.core.volcano import OracleQuery


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    compiles: int = 0     # CompiledQuery constructions (stagings)
    evictions: int = 0
    # selection-vector compaction (passes/compaction.py): executions that
    # ran through a compacted plan, and those whose capacity bucket
    # overflowed at runtime (re-executed via the uncompacted twin).
    compactions: int = 0
    overflows: int = 0
    # adaptive capacity feedback: entries re-planned with capacities
    # derived from observed max counts (after `compact_replan_after`
    # overflows) and entries shrunk to the measured bucket (after
    # `compact_shrink_after` consecutive large underuses).
    replans: int = 0
    shrinks: int = 0
    # serving degradation (serve/query_server.py's ladder): requests
    # prepared against degraded (mask-only, `pipeline.degrade`) settings.
    # Degraded settings key distinct cache entries, so a degraded rung
    # never evicts or pollutes the full-fidelity entry for the same plan.
    degraded: int = 0
    # execution tiering (core/tiering.py, tiered mode only): requests
    # served per ladder rung, background hot-swaps to a higher tier, and
    # promotions that failed (the entry stayed on its ready tier).
    tier_hits: dict = dataclasses.field(default_factory=dict)
    promotions: int = 0
    promote_failures: int = 0
    # feedback records restored from a persisted warm state (persist.py)
    restored: int = 0


@dataclasses.dataclass
class _Feedback:
    """Per-plan-shape runtime observations (keyed by the cache key's base
    — canonical plan + settings + db fingerprint — so every capacity
    generation of one shape shares a single history)."""
    est_params: dict                       # first-seen runtime bindings
    observed: dict = dataclasses.field(default_factory=dict)  # pid -> max
    overrides: Optional[dict] = None       # pid -> count fed to the pass
    overflows: int = 0                     # since the last re-plan
    replans: int = 0
    shrinks: int = 0
    # pid -> per-shard max-count vector (np.ndarray of len n_shards),
    # harvested from sharded entries.  Reporting surface only (benchmarks
    # read it to chart skew); capacity planning keys on the scalar
    # `observed` max, which bounds every shard by construction.
    observed_shard: dict = dataclasses.field(default_factory=dict)
    # capacity generation: bumped by every re-plan/shrink transition so a
    # signature computed against pre-transition overrides (optimize runs
    # outside the lock) can never be memoized after the transition
    gen: int = 0


class PromotionFailed(RuntimeError):
    """A tiered cache on the card could not promote a plan shape to its
    target tier (its kernels failed to build or launch).  Raised to every
    request of the shape from then on: the card serves nothing from the
    host oracle once the kernels are known to fail."""


@dataclasses.dataclass
class _LadderState:
    """Per-cold-plan-key promotion state (tiered mode).  `ready` maps
    tier name -> Runnable, always containing at least the oracle; `plan`
    is a pristine structurally-bound logical plan the promoter compiles
    from (each compile deep-copies it — passes mutate plans)."""
    plan: ir.Plan
    runtime: dict
    ladder: tiering.TierLadder
    ready: dict = dataclasses.field(default_factory=dict)
    promoting: bool = False
    failure: Optional[BaseException] = None     # sticky: promotion gave up
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def best(self) -> tiering.Runnable:
        return self.ready[max(self.ready,
                              key=lambda n: tiering.tier(n).rank)]


class Prepared(tuple):
    """`PlanCache._prepare`'s (key, plan, runtime bindings, plan_owned);
    `memo_hit` is True where the shape memo answered the request."""

    def __new__(cls, items, memo_hit: bool = False):
        self = super().__new__(cls, items)
        self.memo_hit = memo_hit
        return self


class PlanCache:
    def __init__(self, db, max_entries: int = 128, *,
                 tiered: bool = False, promote_through: bool = False,
                 promote_workers: int = 1, device=None):
        self.db = db
        self.device = resolve_device(device)
        self.max_entries = max_entries
        self.stats = CacheStats()
        # execution tiering (docs §11): serve the best ready rung, climb
        # in the background.  `promote_through` climbs rung-by-rung (an
        # interpret-tier program lands before the full compile) at the
        # cost of one extra compile; default is straight to the target.
        self.tiered = tiered
        self.promote_through = promote_through
        self._promote_workers = max(1, promote_workers)
        self._promoter: Optional[ThreadPoolExecutor] = None
        self._ladders: dict[tuple, _LadderState] = {}
        # persisted warm metadata (persist.load_warm_state): key bases
        # that had a compiled entry when the state was saved.  `is_warm`
        # lets a restarted server prioritize known-hot shapes.
        self._warm_hints: set[tuple] = set()
        self._entries: "OrderedDict[tuple, CompiledQuery]" = OrderedDict()
        self._caps_memo: dict[tuple, tuple] = {}
        # `_prepare`'s memos, keyed on the plan object's id: each value
        # holds the plan, so an id stays its plan's while the entry lives
        self._shapes: dict[tuple, tuple] = {}
        self._prepared: dict[tuple, tuple] = {}
        # per-plan-shape feedback: observed counts, override state, and
        # the initial-estimate bindings.  Keyed by the key base, which
        # includes db.fingerprint — a reloaded database starts fresh.
        self._feedback: dict[tuple, _Feedback] = {}
        self._lock = threading.RLock()

    # -- keying ----------------------------------------------------------------
    def _prepare(self, plan: ir.Plan, settings: Settings,
                 bindings: Optional[dict], mode: str):
        """(key, plan, runtime bindings, plan_owned) for a request.

        Bindings are validated here so cache hits and misses behave
        identically: every request must name exactly the plan's parameters
        — a missing or misspelled binding raises whether or not the entry
        is already warm (a warm entry must never silently fall back to the
        first request's values).  `plan_owned` is True when `plan` is a
        private copy safe to hand to CompiledQuery (whose passes mutate it).
        """
        if mode not in ("residual", "specialize"):
            raise ValueError(f"unknown mode {mode!r}")
        bindings = dict(bindings or {})
        names, baked = self._shape_of(plan, mode)
        unknown = sorted(set(bindings) - names)
        if unknown:
            raise KeyError(f"unknown parameters {unknown}; this plan takes "
                           f"{sorted(names)}")
        missing = sorted(names - set(bindings))
        if missing:
            raise KeyError(f"no binding supplied for parameters {missing}")
        runtime = {n: v for n, v in bindings.items() if n not in baked}
        tail = (dataclasses.astuple(settings), self.db.fingerprint,
                self._mesh_size(settings))
        # the shape memo: a repeat of (plan object, baked values, settings,
        # database, mesh) takes the bound plan and the key's base from the
        # first request instead of a deep copy and a repr.  The cache never
        # mutates a caller's plan, and the server already relies on its
        # caller not mutating a plan it submitted.
        memo_key = (id(plan), mode, tuple((type(bindings[n]), bindings[n])
                                          for n in baked)) + tail
        try:
            with self._lock:
                memo = self._prepared.get(memo_key)
        except TypeError:               # an unhashable baked value
            memo_key = memo = None
        hit = memo is not None and memo[0] is plan
        if hit:
            _, base, plan = memo
            owned = False               # the memo's copy is shared
        else:
            given, owned = plan, False
            if baked:
                # substitution mutates expression slots: work on a copy
                plan = bind_plan(copy.deepcopy(plan),
                                 {n: bindings[n] for n in baked})
                owned = True
            # dataclass reprs are recursive and deterministic: they
            # canonicalize the full plan structure including substituted
            # literals.  The db component is the Database's monotonic
            # fingerprint, NOT id(db): ids are reused after GC, and a
            # reused address would hand a new database a stale entry
            # compiled against dead data.
            base = (repr(plan),) + tail
            if memo_key is not None:
                # a pristine copy: an owned plan goes on to
                # `CompiledQuery`, whose passes mutate it
                with self._lock:
                    if len(self._prepared) >= 4 * self.max_entries:
                        self._prepared.clear()
                    self._prepared[memo_key] = (
                        given, base, copy.deepcopy(plan) if owned else plan)
        # The final component is the capacity vector the Compaction pass
        # plants for this plan — the entry's static shapes, made explicit
        # so capacity planning can never alias two entries compiled under
        # different buckets and each bucket retraces at most once.
        # Computing it runs the pass pipeline on a throw-away copy; the
        # memo keys it on the other components, so only the first request
        # for a plan shape pays and warm hits stay walk-free.
        caps = self._capacity_signature(base, plan, settings, runtime)
        return Prepared((base + (caps,), plan, runtime, owned), hit)

    def _shape_of(self, plan: ir.Plan, mode: str) -> tuple:
        """(every parameter name, the sorted names baked into the plan)
        for `plan` under `mode`, memoized on the plan object."""
        with self._lock:
            got = self._shapes.get((id(plan), mode))
        if got is not None and got[0] is plan:
            return got[1:]
        spec = plan_params(plan)
        baked = tuple(sorted(spec)) if mode == "specialize" else \
            tuple(sorted(n for n, i in spec.items() if i.structural))
        with self._lock:
            if len(self._shapes) >= 4 * self.max_entries:
                self._shapes.clear()
            self._shapes[(id(plan), mode)] = (plan, frozenset(spec), baked)
        return frozenset(spec), baked

    def _mesh_size(self, settings: Settings) -> int:
        """Resolved data-mesh size for the cache key.  `astuple(settings)`
        already carries the raw `shards` field, but `shards=0` means "all
        visible devices" — two processes (or one process whose device
        visibility changed) must not share an entry staged for a
        different mesh, so the key carries the *resolved* count, on this
        cache's device."""
        return resolve_shards(settings, self.device)

    def _feedback_for(self, base: tuple, runtime: dict) -> _Feedback:
        """The plan shape's feedback record, created on first sight with
        that request's runtime bindings as the initial-estimate values.
        The base includes db.fingerprint, so a reloaded database can
        never inherit another's observations or estimates."""
        with self._lock:
            fb = self._feedback.get(base)
            if fb is None:
                if len(self._feedback) >= 4 * self.max_entries:
                    # the memoized signatures were computed under the
                    # records being dropped: clear them in tandem, or a
                    # surviving memo would key learned capacities while
                    # compiles see a fresh (override-free) record
                    self._feedback.clear()
                    self._caps_memo.clear()
                fb = self._feedback[base] = _Feedback(
                    est_params=dict(runtime))
            return fb

    def _capacity_signature(self, base: tuple, plan: ir.Plan,
                            settings: Settings, runtime: dict) -> tuple:
        """The capacity vector keyed into the plan key, memoized per base
        as `(caps, est_params, overrides)` — the estimation snapshot the
        vector was computed under, which `_get_prepared` reuses so the
        compiled entry's capacities always equal its key's signature.
        The pass pipeline runs outside the lock; the generation check
        prevents a computation that raced a re-plan/shrink transition
        from memoizing a stale vector over the transition's pop."""
        if not settings.compaction:
            return ()
        # warm path: one lock round-trip, no feedback-record touch
        with self._lock:
            memo = self._caps_memo.get(base)
        if memo is not None:
            return memo[0]
        while True:
            # re-fetched every iteration: the feedback store's wholesale
            # eviction can drop (and a later request re-create) this
            # base's record while optimize() runs outside the lock — a
            # stale `fb` would fail the identity check below forever
            fb = self._feedback_for(base, runtime)
            with self._lock:
                memo = self._caps_memo.get(base)
                if memo is not None:
                    return memo[0]
                gen = fb.gen
                est = dict(fb.est_params)
                overrides = None if fb.overrides is None \
                    else dict(fb.overrides)
            try:
                lowered = optimize(copy.deepcopy(plan), self.db, settings,
                                   est_params=est, observed=overrides,
                                   device=self.device)
                caps = tuple(n.capacity for n in ir.walk(lowered)
                             if isinstance(n, ir.Compact))
            except KeyError:
                # keyed against a database missing the plan's tables (can
                # never compile); () keeps key_for usable for identity
                # checks
                caps = ()
            with self._lock:
                if self._feedback.get(base) is not fb or fb.gen != gen:
                    continue    # transition raced us: recompute
                if len(self._caps_memo) >= 4 * self.max_entries:
                    self._caps_memo.clear()
                self._caps_memo[base] = (caps, est, overrides)
                return caps

    def key_for(self, plan: ir.Plan, settings: Settings,
                bindings: Optional[dict] = None,
                mode: str = "residual") -> tuple:
        return self._prepare(plan, settings, bindings, mode)[0]

    def contains(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def note_degraded(self, n: int = 1) -> None:
        """Count `n` requests served against degraded (mask-only) settings
        — called by QueryServer's shed-to-degraded-plan rung so cache
        stats expose how much traffic ran below full fidelity."""
        with self._lock:
            self.stats.degraded += n

    # -- the cache -------------------------------------------------------------
    def _get_prepared(self, key: tuple, plan: ir.Plan, runtime: dict,
                      owned: bool, settings: Settings,
                      _quiet: bool = False,
                      build: bool = False) -> CompiledQuery:
        # `_quiet` suppresses hit/miss accounting (NOT the compile
        # counter): the tiered promoter compiles through here after the
        # ladder already counted the request, and double-counting would
        # desync hits+misses from the request count.  `build` runs
        # `CompiledQuery.compile` before the entry is published, so no
        # request that finds it pays `nvcc`.
        with self._lock:
            cq = self._entries.get(key)
            if cq is not None:
                self._entries.move_to_end(key)
                if not _quiet:
                    self.stats.hits += 1
                return cq
            if not _quiet:
                self.stats.misses += 1
        # compile outside the lock (long); concurrent duplicate compiles are
        # prevented one level up by QueryServer's in-flight dedup.  Passes
        # mutate the plan, so compile from a private copy.  Estimation
        # inputs come from the memoized snapshot the key's capacity
        # signature was computed under — NOT from this request's bindings
        # — so the compiled capacities always equal the signature inside
        # `key` (falling back to the live feedback record in the rare
        # window where a transition popped the memo after keying: the
        # entry then belongs to the superseded key and is simply retired
        # by LRU once the re-keyed requests stop hitting it).
        est, observed = runtime, None
        if settings.compaction:
            with self._lock:
                memo = self._caps_memo.get(key[:-1])
            if memo is not None:
                _, est, observed = memo
            else:
                fb = self._feedback_for(key[:-1], runtime)
                est, observed = fb.est_params, fb.overrides
        cq = CompiledQuery(plan if owned else copy.deepcopy(plan),
                           self.db, settings, params=runtime,
                           est_params=est, observed=observed,
                           device=self.device)
        if build:
            cq.compile()
        cq._cache_key = key
        with self._lock:
            self.stats.compiles += 1
            self._entries[key] = cq
            while len(self._entries) > self.max_entries:
                old, _ = self._entries.popitem(last=False)
                self._drop_ladder(old)
                self.stats.evictions += 1
        return cq

    def _drop_ladder(self, key: tuple) -> None:
        """Forget the cold-state record of `key` unless a promotion still
        runs on it (caller holds the lock): its ready rungs keep their
        inputs resident."""
        st = self._ladders.get(key)
        if st is not None and not st.promoting:
            del self._ladders[key]

    def get(self, plan: ir.Plan, settings: Settings,
            bindings: Optional[dict] = None, mode: str = "residual"
            ) -> tuple[CompiledQuery, dict]:
        """(compiled query, runtime bindings for this request); stages on
        miss.  The hit path performs no staging and builds nothing."""
        key, prepared, runtime, owned = self._prepare(plan, settings,
                                                      bindings, mode)
        return self._get_prepared(key, prepared, runtime, owned,
                                  settings), runtime

    def execute(self, plan: ir.Plan, settings: Settings,
                bindings: Optional[dict] = None, mode: str = "residual"):
        cq, runtime = self.get(plan, settings, bindings, mode)
        res = cq.run(runtime)
        self._note_compaction(cq, 1)
        return res

    # -- execution tiers (core/tiering.py; docs §11) ---------------------------
    def get_tiered(self, plan: ir.Plan, settings: Settings,
                   bindings: Optional[dict] = None, mode: str = "residual"
                   ) -> tuple[tiering.Runnable, dict, str]:
        """(runnable, runtime bindings, tier name): the best READY tier
        for this request, immediately.  A warm target entry behaves
        exactly like `get`; a cold shape is served by the ladder's bottom
        rung (the Volcano oracle — no staging, no build) while a
        background thread stages the target tier, builds its kernels and
        hot-swaps the entry.  Any
        tier satisfies the same Runnable contract, so callers execute the
        result identically regardless of rung."""
        key, prepared, runtime, owned = self._prepare(plan, settings,
                                                      bindings, mode)
        return self._get_tiered_prepared(key, prepared, runtime, owned,
                                         settings)

    def _get_tiered_prepared(self, key: tuple, plan: ir.Plan,
                             runtime: dict, owned: bool, settings: Settings,
                             compile_hook: Optional[Callable] = None
                             ) -> tuple[tiering.Runnable, dict, str]:
        ladder = tiering.TierLadder(settings)
        with self._lock:
            cq = self._entries.get(key)
            if cq is not None:
                # target tier ready: the classic warm hit
                self._entries.move_to_end(key)
                self.stats.hits += 1
                self._tier_hit(ladder.target.name)
                return cq, runtime, ladder.target.name
            st = self._ladders.get(key)
            if st is None:
                if len(self._ladders) >= 4 * self.max_entries:
                    # bound the cold-state table; in-flight promotions
                    # keep their state (the job holds its own reference)
                    self._ladders = {k: s for k, s in self._ladders.items()
                                     if s.promoting}
                st = _LadderState(plan if owned else copy.deepcopy(plan),
                                  dict(runtime), ladder)
                self._ladders[key] = st
                self.stats.misses += 1
            else:
                self.stats.hits += 1
        if ladder.target is tiering.ORACLE:
            # volcano-engine settings: the ladder is one rung, nothing to
            # promote toward
            run = self._ensure_oracle(st)
            st.done.set()
            self._tier_hit(run.tier_name)
            return run, runtime, run.tier_name
        self._ensure_oracle(st)
        self._maybe_promote(key, st, settings, compile_hook)
        with self._lock:
            failure, best = st.failure, st.best()
        if failure is not None and self.device.type == "cuda":
            raise PromotionFailed(
                f"the {ladder.target.name} tier of this plan shape failed "
                f"to build on {self.device}: {failure!r}") from failure
        self._tier_hit(best.tier_name)
        return best, runtime, best.tier_name

    def _tier_hit(self, name: str) -> None:
        with self._lock:
            self.stats.tier_hits[name] = self.stats.tier_hits.get(name, 0) + 1

    def _ensure_oracle(self, st: _LadderState) -> tiering.Runnable:
        """The ladder's always-ready bottom rung, built at most once per
        state.  Construction is microseconds (no staging), so racing
        builders waste nothing; the first to publish wins."""
        with self._lock:
            got = st.ready.get(tiering.ORACLE.name)
            if got is not None:
                return got
        oq = OracleQuery(st.plan, self.db, params=st.runtime)
        with self._lock:
            return st.ready.setdefault(tiering.ORACLE.name, oq)

    def _maybe_promote(self, key: tuple, st: _LadderState,
                       settings: Settings,
                       compile_hook: Optional[Callable]) -> None:
        """Schedule one background promotion toward the target tier.
        Deduplicated per key (`st.promoting`); a sticky failure stops the
        climb for this state — on the CPU the ready tier keeps serving, on
        the card the shape's requests raise it — and a later
        eviction/re-key starts a fresh ladder."""
        with self._lock:
            if st.promoting or st.failure is not None or st.done.is_set():
                return
            st.promoting = True
            if self._promoter is None:
                self._promoter = ThreadPoolExecutor(
                    max_workers=self._promote_workers,
                    thread_name_prefix="plan-cache-promote")
            pool = self._promoter
        try:
            pool.submit(self._promote, key, st, settings, compile_hook)
        except RuntimeError as e:      # pool shut down (cache closed)
            with self._lock:
                st.promoting = False
                st.failure = e
                st.done.set()

    def _promote(self, key: tuple, st: _LadderState, settings: Settings,
                 compile_hook: Optional[Callable]) -> None:
        """Background promotion job: stage the rung(s) above the best
        ready tier, build their kernels (`CompiledQuery.compile`, so no
        request pays `nvcc`) and hot-swap each into the ladder as it
        lands.  The target tier also becomes the canonical
        `_entries[key]` entry, so every later request takes the plain
        warm-hit path."""
        ladder = st.ladder
        try:
            with self._lock:
                ready = tiering.tier(st.best().tier_name)
            for t in ladder.promotion_path(ready, self.promote_through):
                if compile_hook is not None:
                    compile_hook(key)
                if t is ladder.target:
                    cq = self._get_prepared(key, copy.deepcopy(st.plan),
                                            st.runtime, True, settings,
                                            _quiet=True, build=True)
                else:
                    # intermediate rung (interpret): a cheaper program
                    # under the tier's settings.  It lives only in the
                    # ladder — its settings differ from the request's, so
                    # it must never be keyed as the target entry.
                    cq = CompiledQuery(copy.deepcopy(st.plan), self.db,
                                       ladder.settings_for(t),
                                       params=st.runtime,
                                       device=self.device)
                    cq.tier_name = t.name
                    cq.compile()
                    with self._lock:
                        self.stats.compiles += 1
                with self._lock:
                    st.ready[t.name] = cq
                    self.stats.promotions += 1
            with self._lock:
                st.promoting = False
                st.done.set()
                # fully promoted: requests now hit _entries directly and
                # the cold-state record has done its job
                if self._ladders.get(key) is st:
                    del self._ladders[key]
        except BaseException as e:
            with self._lock:
                st.promoting = False
                st.failure = e
                st.done.set()
                self.stats.promote_failures += 1

    def await_promotion(self, plan: ir.Plan, settings: Settings,
                        bindings: Optional[dict] = None,
                        mode: str = "residual",
                        timeout: Optional[float] = None) -> bool:
        """Block until the background promotion for this request's key
        settles (hot-swap complete or failed); True when the target tier
        is ready.  Deterministic handle for tests and benchmarks — the
        serving path never needs it."""
        key = self.key_for(plan, settings, bindings, mode)
        with self._lock:
            if key in self._entries:
                return True
            st = self._ladders.get(key)
        if st is None:
            return self.contains(key)
        st.done.wait(timeout)
        return self.contains(key)

    def execute_tiered(self, plan: ir.Plan, settings: Settings,
                       bindings: Optional[dict] = None,
                       mode: str = "residual"):
        """(result, tier name): `execute` through the tier ladder."""
        run, runtime, tier_name = self.get_tiered(plan, settings, bindings,
                                                  mode)
        res = run.run(runtime)
        self._note_compaction(run, 1)
        return res, tier_name

    def is_warm(self, plan: ir.Plan, settings: Settings,
                bindings: Optional[dict] = None,
                mode: str = "residual") -> bool:
        """True when this request's shape had a compiled entry in a
        previously persisted warm state (or has one live right now) — a
        restarted server's signal for which shapes to promote eagerly."""
        key = self.key_for(plan, settings, bindings, mode)
        with self._lock:
            return key in self._entries or key[:-1] in self._warm_hints

    # -- persistence (core/persist.py; docs §11) -------------------------------
    def save(self, path: str) -> int:
        """Persist the feedback store + warm metadata; returns records
        written.  Pair with a lasting kernel build directory
        (`persist.enable_compilation_cache`) so the `nvcc` builds survive
        too."""
        return persist_mod.save_warm_state(self, path)

    def load(self, path: str) -> int:
        """Restore a persisted warm state; returns records restored (0 =
        cold start: missing/corrupt/version-skewed/different-data files
        are silently ignored).  Restored capacity overrides flow into the
        first compile of each shape, so request 1 runs at the
        pre-restart converged capacities — no re-convergence overflows."""
        return persist_mod.load_warm_state(self, path)

    def close(self) -> None:
        """Stop the background promoter (if any) and drop every entry and
        ladder.  A promotion already running is waited for, and queued
        ones are cancelled: a thread still inside a CUDA call when the
        interpreter exits can crash or hang the process.  The feedback
        store and the statistics stay; a later request stages afresh.
        Idempotent."""
        with self._lock:
            pool, self._promoter = self._promoter, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        with self._lock:
            self._entries.clear()
            for st in self._ladders.values():
                st.done.set()
            self._ladders.clear()

    def _note_compaction(self, cq: CompiledQuery, n_execs: int) -> None:
        """Compaction accounting for `n_execs` executions just performed on
        `cq`: compacted executions and the overflows since the entry's
        last harvest, then the adaptive-feedback step."""
        if not cq.compaction_points:
            return
        got = cq.observations.harvest()
        with self._lock:
            self.stats.compactions += n_execs
            self.stats.overflows += got.overflows
            self._feedback_step(cq, got)

    def _feedback_step(self, cq: CompiledQuery, got: Harvest) -> None:
        """Close the loop between runtime and planner (caller holds the
        lock): merge the entry's harvested counts into the plan shape's
        feedback record, then —

          * after `compact_replan_after` overflows, re-plan the shape with
            capacities derived from the observed max counts (the stale
            entry is evicted; the next request compiles against measured
            headroom);
          * after `compact_shrink_after` consecutive large underuses
            (every point < capacity/4), shrink to the bucket over the
            streak's window max (a historical spike must not pin
            capacity up forever).

        Each transition costs at most one retrace per direction: the new
        capacity vector is a new plan key, compiled once."""
        s = cq.settings
        if not (s.compaction and s.compact_feedback) \
                or cq._cache_key is None:
            return
        base = cq._cache_key[:-1]
        fb = self._feedback.get(base)
        if fb is None:
            return
        # translate points are exempt from shrink decay: a translate
        # overflow silently drops build rows the probe then misses (wrong
        # answers, not just a fallback re-execution), so their capacity
        # floors at the all-time max (`translate_bucket` in the pass) and
        # the window-max decay below must never touch them
        streak_max = {pid: c for pid, c in got.streak_max.items()
                      if pid not in cq.translate_points}
        for pid, c in got.observed.items():
            if c > fb.observed.get(pid, -1):
                fb.observed[pid] = c
        for pid, v in got.observed_shard.items():
            old = fb.observed_shard.get(pid)
            fb.observed_shard[pid] = v if (
                old is None or old.shape != v.shape
            ) else np.maximum(old, v)
        fb.overflows += got.overflows
        if fb.overflows >= s.compact_replan_after:
            fb.overrides = {**(fb.overrides or {}), **fb.observed}
            fb.overflows = 0
            fb.replans += 1
            self.stats.replans += 1
            self._retire(cq, base, fb)
        elif got.under_streak >= s.compact_shrink_after and streak_max \
                and any(observed_bucket(c) < cq.point_caps.get(pid, 0)
                        for pid, c in streak_max.items()
                        if pid in cq.point_caps):
            fb.overrides = {**(fb.overrides or {}), **streak_max}
            # the shrink is evidence the old maxima are stale: decay
            # fb.observed to the window max too, or a later re-plan
            # would resurrect a historical spike and ping-pong the
            # capacity back up (docs §6: "a historical spike cannot
            # pin capacity up")
            fb.observed.update(streak_max)
            fb.shrinks += 1
            self.stats.shrinks += 1
            self._retire(cq, base, fb)

    def _retire(self, cq: CompiledQuery, base: tuple,
                fb: _Feedback) -> None:
        """Drop a re-planned entry's stale state (caller holds the lock):
        the memoized capacity signature (the next `_prepare` recomputes it
        under the new overrides, producing a new key) and the compiled
        entry itself.  `fb.gen` advances so a signature computed against
        the pre-transition overrides can never be memoized afterwards.
        The entry is *detached* (`_cache_key = None`): a caller still
        holding `cq` can keep executing it, but its observations are no
        longer harvested — they were consumed by this transition, and
        re-merging them would resurrect deliberately decayed maxima."""
        fb.gen += 1
        self._caps_memo.pop(base, None)
        if self._entries.get(cq._cache_key) is cq:
            del self._entries[cq._cache_key]
        self._drop_ladder(cq._cache_key)
        cq._cache_key = None
        cq.observations.reset_streak()

    # -- batched execution -----------------------------------------------------
    def run_many(self, cq: CompiledQuery, runtime_list) -> list:
        """`cq.run_many` with the compaction accounting of its
        executions.  Nothing is padded in the port (N bindings are batched
        staged walks, with no trace to amortise), so there is no pad-slot
        or retrace count."""
        runtime_list = list(runtime_list)
        results = cq.run_many(runtime_list)
        self._note_compaction(cq, len(runtime_list))
        return results

    def execute_many(self, plan: ir.Plan, settings: Settings,
                     bindings_list, mode: str = "residual") -> list:
        """Execute N bindings of one logical plan, running every group of
        bindings that shares a plan key through one `run_many`.

        Compile-time (string / LIMIT) parameters partition the batch
        first: bindings that substitute to different plan structures can
        never share a staged program, so each structural group compiles
        (or hits) its own entry and runs as its own batch.  Results are
        returned positionally, matching `bindings_list`."""
        prepared = [self._prepare(plan, settings, b, mode)
                    for b in bindings_list]
        groups: "OrderedDict[tuple, list[int]]" = OrderedDict()
        for i, (key, _, _, _) in enumerate(prepared):
            groups.setdefault(key, []).append(i)
        results: list = [None] * len(prepared)
        for key, idxs in groups.items():
            _, plan_i, runtime_i, owned_i = prepared[idxs[0]]
            cq = self._get_prepared(key, plan_i, runtime_i, owned_i,
                                    settings)
            # _get_prepared counted one hit/miss per *group*; the other
            # members are hits on the same entry.
            with self._lock:
                self.stats.hits += len(idxs) - 1
            if len(idxs) == 1:
                results[idxs[0]] = cq.run(runtime_i)
                self._note_compaction(cq, 1)
                continue
            for i, res in zip(idxs, self.run_many(
                    cq, [prepared[i][2] for i in idxs])):
                results[i] = res
        return results

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def pass_replays(self) -> int:
        """Batched passes replayed as one CUDA graph (`core/graphs.py`)
        by the plans the cache holds."""
        with self._lock:
            return sum(cq.n_pass_replays for cq in self._entries.values())

    @staticmethod
    def stagings() -> int:
        """Global CompiledQuery construction count (for compile-counter
        assertions independent of cache bookkeeping)."""
        return compile_mod.STAGINGS
