"""Whole-query staging: lowered plan -> one specialized torch program.

The physical operators (`repro_torch.core.operators`) are pure
`stage(node, ctx) -> Frame` functions; this module runs their dispatch
twice and wraps the result in a `CompiledQuery`:

  * the collection walk runs the operators on 8-row CPU samples of every
    input.  It registers the exact input set of the query (per-query
    specialized loading, §3.6.1) under the same keys as the reference
    package, and exercises every static decision once;
  * the staged walk runs the same operators on the registered inputs,
    eagerly, on the query's device.  The inputs are copied there once, at
    construction, and stay resident: `run` sends nothing but the bound
    parameter scalars.

Query-specific literals (date-slice bounds, dictionary codes, key domains,
strides, pruned column sets) are baked in at staging time.  `Param` nodes
are the exception: a numeric parameter is an input of the staged program
(`param/<name>`), so `run(params=...)` re-executes without re-staging,
and a kernel takes it as a scalar argument without being rebuilt.

Selection-vector compaction gives the staged walk a third output: a dict
mapping each compaction point's id to its TRUE valid count.  A count
above the point's planned capacity means the static bucket dropped rows,
so `run` discards the outputs and re-executes through the lazily built
*uncompacted twin* of the same logical plan — compaction is a performance
bet whose worst case is latency, never wrong results.  The counts are
also recorded per query (`observations`: the all-time max per point,
underuse streaks; `core/observations.py`) and harvested by `PlanCache`'s
feedback store, which re-plans capacities from measured headroom after
repeated overflows and shrinks them after sustained underuse.

After the walk, every run mode (the scalar walks, their graph replay, a
batched pass, `CompiledQueryBatch`) settles through one pipeline
(`_settle`): the point counts of all its walks are read in one copy
(`_counts_to_host`) and recorded, the frames of the bindings that fit
are copied to the host (`_to_host`), each answer is decoded, and the
bindings that overflowed re-run through the twin.

Bind-many: `run_many(bindings_list)` runs N bindings as batched passes
of at most BATCH_MAX bindings, each ONE staged walk under
`torch.func.vmap` (the counterpart of the reference's vmapped
`fn_many`); below BATCH_MIN bindings it runs one scalar walk a binding
instead, which costs less there.  In a pass the `param/<name>` inputs
are (N,) tensors on the query's device, bound in one host-to-device
copy, and vmap batches them; the base columns and index structures are not mapped (their
resident tensors enter the walk once, shared by every binding).  Every
operator's torch ops carry the binding axis through vmap's batching
rules, and each engine kernel's custom operator through its vmap rule
(`kernels/ops.py`): one launch a call site for all N bindings.  The
point counts come out as (N,) vectors, read in one device-to-host copy;
only the slots whose capacity overflowed re-run, through the twin's
`run_many` of their bindings.  Each slot's answer is
`run(bindings_list[i])`'s.  Unlike the reference, which pads N to a
power-of-two bucket so that it retraces at most log2(N) times, eager
torch has no trace to amortise, so nothing is padded (`pads_batches =
False`).  `run` keeps the scalar walk, its parameters host scalars.

CUDA graph replay: on CUDA, `compile()` captures an unsharded query's
scalar walk as CUDA graphs cut at the engine's entry points
(`core/graphs.py`), and `run` (and `run_many` below BATCH_MIN, one
binding at a time) replays them: one parameter copy, the segments, and
between them the entry points called eagerly with the binding's host
scalars.  Replay holds a lock from the parameter copy until the result is
on the host; a run that finds it held takes the eager walk, as do
sharded queries, `CompiledQueryBatch`, the overflow twin and the CPU.
A batched pass of exactly BATCH_MAX bindings (`replays_pass`) is
captured whole, as one graph, on the query's first such pass, and
replayed from then on: one copy of the bindings from a pinned buffer and
the graph, under a lock of its own, released as the scalar replay's is.
Every other pass (any other N, sharded, on the CPU, the twin's, one
that finds the lock held, or one of a query whose capture raised or
found no room on the device) is the eager vmapped walk; nothing is
padded to reach a graph.

Sharded execution (`Settings.shards != 1`): the Sharding pass partitions
the partition root and the tables routed to it over a 1-D data mesh
(`core/mesh.py`); the collection walk registers their partitioned
copies under shard-scoped keys, and those are split into one block per
shard at construction.  `execute` runs the staged walk once per shard,
each in a thread of its own on its block (`DataMesh.run`, the
counterpart of the reference's `shard_map`); the collectives combine in
rank order, so every shard's output is the same, and shard 0's is the
result.  Each point's count is an `(n_shards,)` vector, read in the same
one device-to-host copy; overflow and the scalar feedback key off the
worst shard, and the record keeps the per-shard maxima
(`observed_shard`).  A sharded batched pass (`run_many`, `run_batched`,
`execute_many`) runs one staged walk under `torch.func.vmap` in each
shard's thread, the counterpart of the reference's
`shard_wrap(fn_many)`: the parameter vectors are bound once (and copied
once to each other device of the mesh), every shard maps them over its
own blocks, and its collectives go through their vmap rule
(`core/backend.py`), which exchanges plain tensors with the bindings in
front.  Each point's counts come out as an `(N, n_shards)` tensor; each
slot's overflow keys off its worst shard, and `observed_shard` takes the
elementwise max over the slots.  Each shard's block of a partitioned
input is an allocation of its own, so every block starts aligned as an
unsharded column does and the batched kernels take the same route on
every shard.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import graphs, ir
from repro_torch.core.backend import TorchBackend
from repro_torch.core.expr import Param
from repro_torch.core.mesh import AXIS, data_mesh, resolve_shards
from repro_torch.core.operators import StageCtx, frame_nrows
from repro_torch.core.observations import Observations, read
from repro_torch.core.passes.param_binding import (check_bindings,
                                                   runtime_params)
from repro_torch.core.passes.pipeline import Settings, optimize
from repro_torch.core.spans import span
from repro_torch.relational.loader import Database

_SAMPLE = 8
# a result frame of more rows than this is cut to its valid rows on the
# device before it is copied to the host; a smaller one is copied whole
# and masked on the host.  A generic (sort-based) aggregation pads its
# result to its input's row count (6 M rows for lineitem at TPC-H SF 1,
# whose whole copy takes 73 to 173 ms on an H100, the selection under
# 1); below a few thousand rows the selection's `nonzero` and a gather
# a column cost 0.03 to 0.16 ms more than the whole copy.  The cut lies
# between the largest frame measured where the whole copy won (5,000
# rows) and the smallest where the selection won (150,000):
# benchmarks/bench_torch_result_copy.py, PERF.md §5
DEVICE_SELECT_ROWS = 1 << 16

# bind-many by the number of bindings N (`run_many`), from the card's
# measurements (`chip_smoke.py` phase 7 (b), PERF.md §5): below
# BATCH_MIN bindings N scalar walks cost less than one batched pass
# (vmap's wrapping costs host time a pass); a pass takes at most
# BATCH_MAX bindings, the largest measured, so that its device memory
# (which grows with N) stays within the measured pass's
BATCH_MIN = 3
BATCH_MAX = 64


def replays_pass(n: int, n_shards: int, device, twin: bool) -> bool:
    """Does a batched pass of `n` bindings replay as one CUDA graph
    (`core/graphs.py`)?  A full pass (BATCH_MAX bindings) of an unsharded
    query on CUDA that is not an overflow twin does; every other pass is
    the eager vmapped walk."""
    return n == BATCH_MAX and n_shards == 1 \
        and torch.device(device).type == "cuda" and not twin

# stagings in this process: one per CompiledQuery construction.  The
# runtime layer's tests read it to show that re-binding parameters stages
# nothing; a server stages on its pool threads, hence the lock.
STAGINGS = 0
_STAGINGS_LOCK = threading.Lock()


def resolve_device(device=None, what: str = "CompiledQuery") -> torch.device:
    """`None` means the CUDA card; there is no silent CPU path — a caller
    who wants the CPU asks for it.  `what` names the caller in the
    error."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class CompiledQuery:
    """A staged query, resident on `device`.  `params` supplies bindings
    for every runtime (numeric) Param left residual in the optimized plan;
    they are also the values used during the collection walk.
    Compile-time params (string values, Limit.n) must have been
    substituted before construction — pass `bindings` to `optimize`.
    `pool` (unsharded only): a dict of resident inputs shared with other
    queries, by input key; the query takes a key's tensor from it, and
    adds the ones it copies (`CompiledQueryBatch`)."""

    # tiering.Runnable surface: a batch is vmapped staged walks (or
    # scalar ones below BATCH_MIN), never padded
    pads_batches = False
    n_executions = read("n_executions")     # one a walk, replay or pass
    n_overflows = read("n_overflows")       # one an overflowed binding
    observed_max = read("observed_max")
    observed_shard = read("observed_shard")

    def __init__(self, plan: ir.Plan, db: Database, settings: Settings,
                 params: Optional[dict] = None,
                 est_params: Optional[dict] = None,
                 observed: Optional[dict] = None,
                 device=None, pool: Optional[dict] = None):
        global STAGINGS
        self.device = resolve_device(device)
        with _STAGINGS_LOCK:
            STAGINGS += 1
        self.db = db
        self.settings = settings
        # the tiered cache overwrites it for a lower rung ('interpret')
        self.tier_name = "opt-pallas" if settings.use_pallas else "compiled"
        # compaction plants static-capacity points from cardinality
        # *estimates*; keep a pristine copy of the logical plan so an
        # estimate that undershoots at runtime can build the uncompacted
        # twin lazily.  A measure-only twin plants nothing that can
        # overflow, so it needs no fallback of its own.
        pristine = copy.deepcopy(plan) \
            if (settings.compaction and not settings.compact_measure_only) \
            or any(isinstance(n, ir.Compact) and n.capacity > 0
                   for n in ir.walk(plan)) else None
        t0 = time.perf_counter()
        self.plan = optimize(plan, db, settings,
                             est_params=est_params
                             if est_params is not None else (params or {}),
                             observed=observed, device=self.device)
        self.pass_time = time.perf_counter() - t0
        # hand-planted Compact nodes get stable `h<i>` ids; then the points
        # split into real compaction points (capacity > 0) and
        # measure-only probes (capacity 0 — the overflow twin's
        # observation points, which count but never truncate)
        h, compacts = 0, []
        for n in ir.walk(self.plan):
            if isinstance(n, ir.Compact):
                if n.point_id is None:
                    n.point_id = f"h{h}"
                    h += 1
                compacts.append(n)
        real = [n for n in compacts if n.capacity > 0]
        self.compaction_points = len(real)
        self.capacities = tuple(n.capacity for n in real)
        self.point_caps = {n.point_id: int(n.capacity) for n in real}
        # translate points carry the key->slot contract whose overflow
        # drops rows a probe then misses: PlanCache's shrink decay exempts
        # them, so their capacities floor at the all-time measured max
        self.translate_points = {n.point_id for n in real if n.translate}
        self.measure_points = len(compacts) - len(real)
        self._pristine = pristine if real else None
        self._fallback: Optional["CompiledQuery"] = None
        self._fallback_lock = threading.Lock()
        # the run counters and the feedback state PlanCache harvests
        self.observations = Observations(self.point_caps)
        # the scalar walk captured as CUDA graphs by compile() (unsharded,
        # on CUDA; `core/graphs.py`), the runs that replayed it, and why
        # its capture raised where it did.  One replay at a time: a run
        # that finds the lock held takes the eager walk
        self._graph: Optional[graphs.WalkGraph] = None
        self._replay_lock = threading.Lock()
        self.n_replays = 0
        self.capture_error: Optional[str] = None
        # a full batched pass captured as one CUDA graph, on the first
        # such pass (`replays_pass`), the passes that replayed it, and why
        # its capture raised where it did; one replay at a time, as above.
        # The overflow twin (measure-only) never captures one
        self._pass_graph: Optional[graphs.PassGraph] = None
        self._pass_lock = threading.Lock()
        self.n_pass_replays = 0
        self.pass_capture_error: Optional[str] = None
        self._cache_key: Optional[tuple] = None   # set by PlanCache
        self.compile_time: Optional[float] = None
        # sharded execution: the Sharding pass resolved the same settings
        # on the same device, so the mesh shape here matches the
        # per-shard capacities it planted
        self.n_shards = resolve_shards(settings, self.device)
        self._mesh = data_mesh(self.n_shards, self.device) \
            if self.n_shards > 1 else None
        self._shard_plan = db.shard_plan(self.n_shards) \
            if self._mesh is not None else None

        self.param_spec, self.param_defaults = runtime_params(
            self.plan, params, "optimize(..., bindings=...)")

        # 1. collection walk (CPU, 8-row samples): registers inputs and
        #    output schema; every static decision is exercised here.
        t0 = time.perf_counter()
        self.inputs: dict[str, np.ndarray] = {}

        def collect_input(key, make):
            if key not in self.inputs:
                self.inputs[key] = np.asarray(make())
            v = self.inputs[key]
            if v.ndim == 0:                     # params are scalars
                return v
            return torch.from_numpy(np.ascontiguousarray(v[:_SAMPLE]))

        sampler = StageCtx(db, settings, TorchBackend("cpu"), collect_input,
                           self.param_defaults, device=torch.device("cpu"),
                           staged=False, **self._mesh_ctx())
        sample_frame = sampler.stage(self.plan)
        self.out_meta = [(name, b.kind, b.table, b.col)
                         for name, b in sample_frame.cols.items()]
        # input keys whose arrays are partitioned over the data axis
        # (registered by sharded Scans during the collection walk)
        self.sharded_keys = frozenset(sampler.sharded_keys)
        # a dead-but-declared param must still be an input of the program
        for name, dtype in self.param_spec.items():
            sampler.param(Param(name, dtype))

        # 2. the resident inputs: every base column and index structure is
        #    copied to the device once, here; params are bound per run.
        #    Under a mesh each shard gets its own dict (`shard_resident`):
        #    its block of every partitioned input and the replicated rest.
        self.resident: dict = {}
        self.shard_resident: list[dict] = []
        if self._mesh is None:
            pool = {} if pool is None else pool
            for k, v in self.inputs.items():
                if not k.startswith("param/"):
                    if k not in pool:
                        pool[k] = torch.from_numpy(v).to(self.device)
                    self.resident[k] = pool[k]
        else:
            self.shard_resident = self._shard_blocks()
        self.stage_time = time.perf_counter() - t0

    def _mesh_ctx(self) -> dict:
        """The StageCtx fields of a sharded walk (none unsharded)."""
        if self._mesh is None:
            return {}
        return dict(axis=AXIS, n_shards=self.n_shards,
                    shard_plan=self._shard_plan)

    def _shard_blocks(self) -> list[dict]:
        """One resident input dict per shard.  A partitioned input's
        block s is rows [s*P, (s+1)*P) of its padded copy, copied to its
        shard's device as an allocation of its own, even where every
        shard sits on one device: a view at row s*P would start P rows
        into one tensor, off the 16-byte boundary the batched kernels'
        staged routes read from (`filter_agg.staged_operands`,
        `compact.shared_tile`) whenever P times the row's bytes is not a
        multiple of 16.  A replicated input is copied once a device."""
        devs = self._mesh.devices
        n = self.n_shards
        blocks: list[dict] = [{} for _ in range(n)]
        for k, v in self.inputs.items():
            if k.startswith("param/"):
                continue
            if k not in self.sharded_keys:
                on = {d: torch.from_numpy(v).to(d) for d in set(devs)}
                for s, d in enumerate(devs):
                    blocks[s][k] = on[d]
                continue
            rows = v.shape[0] // n      # ShardPlan pads to n blocks
            for s, d in enumerate(devs):
                blocks[s][k] = torch.from_numpy(np.ascontiguousarray(
                    v[s * rows:(s + 1) * rows])).to(d, copy=True)
        return blocks

    def _synchronize(self) -> None:
        """Wait for every CUDA device the query runs on."""
        devs = self._mesh.devices if self._mesh is not None \
            else (self.device,)
        for d in set(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def compile(self) -> float:
        """Build every kernel library the staged walk reaches: one walk
        under the construction-time bindings and, for a plan with
        parameters, one batched pass of them (the batched instances of
        `run_many`), then wait for the device.  A plan's first run at
        `opt-pallas` otherwise pays `nvcc` for each generated predicate
        it has not met yet.  An unsharded query on CUDA then captures its
        scalar walk as CUDA graphs, which `run` replays (`core/graphs.py`);
        a capture that raises leaves the query on the eager walk.  The
        walks are not executions: nothing is observed or counted.
        Returns (and keeps as `compile_time`) its seconds."""
        t0 = time.perf_counter()
        self.execute(self.bind())
        if self.param_spec:
            self.execute_many(self.bind_many([self.param_defaults]))
        self._synchronize()
        if self._mesh is None and self.device.type == "cuda" \
                and self._graph is None and self.capture_error is None:
            try:
                self._graph = graphs.capture(self)
            except Exception as e:      # noqa: BLE001 - counted and logged
                self.capture_error = f"{type(e).__name__}: {e}"
                graphs.failed(e)
        self.compile_time = time.perf_counter() - t0
        return self.compile_time

    @property
    def graph_segments(self) -> int:
        """The segments the captured walk was cut into, one more than its
        entry-point calls (0: not captured)."""
        return len(self._graph.segments) if self._graph is not None else 0

    # -- parameter binding -----------------------------------------------------
    def bind(self, params: Optional[dict] = None) -> dict:
        """Input dict for one execution: the resident columns plus the
        per-execution parameter scalars.  A non-None `params` must name
        *every* runtime parameter."""
        merged = check_bindings(self, params)
        inputs = dict(self.resident)
        for name, dtype in self.param_spec.items():
            inputs[f"param/{name}"] = np.asarray(merged[name], dtype=dtype)
        return inputs

    # -- execution -------------------------------------------------------------
    def execute(self, inputs: dict):
        """The staged walk: (columns, mask, per-point counts), all on the
        device, nothing synchronized.  Under a mesh: shard 0's columns and
        mask (every shard's are the same) and each point's counts as an
        `(n_shards,)` vector."""
        if self._mesh is None:
            return self._walk(inputs, self.device)
        return self._shard_zero(self.execute_shards(inputs))

    def execute_shards(self, inputs: dict) -> list:
        """The sharded staged walk: every shard's (columns, mask, counts),
        in rank order.  `inputs` is `bind()`'s: the bound parameters; each
        shard reads its own resident blocks."""
        per = [{**blocks, **inputs} for blocks in self.shard_resident]
        devs = self._mesh.devices
        return self._mesh.run(
            lambda rank, group, inp: self._walk(inp, devs[rank], group, rank),
            per)

    def _shard_zero(self, shards: list) -> tuple:
        """Shard 0's columns and mask (every shard's are the same) and
        each point's counts of every shard on its device, the shards
        last: `(n_shards,)` from scalar walks, `(N, n_shards)` from
        batched ones (the mask's leading shape)."""
        out, mask, counts = shards[0]
        dev = self._mesh.devices[0]
        return out, mask, {
            pid: torch.stack([torch.as_tensor(s[2][pid], device=dev)
                              .reshape(mask.shape[:-1]) for s in shards], -1)
            for pid in counts}

    def _walk(self, inputs: dict, device, group=None, rank: int = 0,
              token=None, engine=None):
        """One staged walk on `device`; a sharded one as shard `rank` of
        `group`.  `token`: in a batched walk, a tensor vmap batches, which
        the collectives take (`TorchBackend`).  `engine`: the capture's
        hook on the engine entry points (`StageCtx.engine`)."""
        with span("repro.walk"):
            ctx = StageCtx(self.db, self.settings,
                           TorchBackend(device, group, rank, token),
                           lambda key, make: inputs[key],
                           self.param_defaults, device=device, staged=True,
                           engine=engine, **self._mesh_ctx())
            frame = ctx.stage(self.plan)
            out = {name: b.arr for name, b in frame.cols.items()}
            mask = frame.mask if frame.mask is not None \
                else ctx.ones(frame_nrows(frame))
            return out, mask, dict(ctx.compact_counts)

    def _fallback_query(self) -> "CompiledQuery":
        """The uncompacted twin: same logical plan, no truncating points,
        built lazily on the first overflow, at most once.  It runs in
        *measure-only* mode, so its probes report every site's TRUE
        count."""
        from repro_torch.core.passes.compaction import strip_compaction

        with self._fallback_lock:
            if self._fallback is None:
                self._fallback = CompiledQuery(
                    strip_compaction(self._pristine), self.db,
                    dataclasses.replace(self.settings,
                                        compact_measure_only=True),
                    params=self.param_defaults, device=self.device)
                self._pristine = None   # handed over (passes mutated it)
            return self._fallback

    def run(self, params: Optional[dict] = None) -> dict[str, np.ndarray]:
        """One binding through the scalar staged walk (parameters as host
        scalars), replayed where `compile()` captured it."""
        return self._walks([params])[0]

    def _walks(self, bindings_list: list) -> list[dict[str, np.ndarray]]:
        """One scalar staged walk a binding, enqueued back to back, then
        settled.  A lone binding replays the captured walk where there is
        one and no other run is replaying it."""
        if len(bindings_list) == 1 and self._graph is not None \
                and self._replay_lock.acquire(blocking=False):
            return [self._replayed(bindings_list[0])]
        return self._settle(
            bindings_list, [self.execute(self.bind(b)) for b in bindings_list])

    def _replayed(self, params: Optional[dict]) -> dict[str, np.ndarray]:
        """`run(params)` through the captured walk.  The caller holds
        `_replay_lock`; it is released once the counts and the result are
        on the host, since the next replay writes the same tensors."""
        release = self._replay_lock.release
        try:
            run = self._graph.replay(check_bindings(self, params))
            self.n_replays += 1
        except BaseException:
            release()
            raise
        return self._settle([params], [run], release=release)[0]

    def run_many(self, bindings_list) -> list[dict[str, np.ndarray]]:
        """N bindings as batched passes (the module docstring): each pass
        one staged walk under vmap of at most BATCH_MAX bindings (the
        passes of one call differ in size by one at most), its
        (N,) point counts ((N, n_shards) on a mesh) read in one copy,
        then each slot decoded; below BATCH_MIN bindings, one scalar walk
        a binding.
        Returns one result per binding, in order, each equal to
        `run(bindings_list[i])`; a None binding means the construction-
        time bindings.  Only overflowing slots re-run, through the twin.
        A plan with no runtime parameters runs once and returns
        independent copies (a caller may mutate its result in place)."""
        bindings_list = list(bindings_list)
        merged = [check_bindings(self, b) for b in bindings_list]
        if not bindings_list:
            return []
        if not self.param_spec:
            res = self.run(bindings_list[0])
            return [res] + [{k: np.copy(v) for k, v in res.items()}
                            for _ in bindings_list[1:]]
        if len(merged) < BATCH_MIN:
            return self._walks(bindings_list)
        # passes of at most BATCH_MAX bindings, of equal size within one
        # (so none falls below BATCH_MIN)
        k = -(-len(merged) // BATCH_MAX)
        cuts = [len(merged) * i // k for i in range(k + 1)]
        results = []
        for a, b in zip(cuts, cuts[1:]):
            results += self._pass(bindings_list[a:b], merged[a:b])
        return results

    def run_batched(self, bindings_list) -> list[dict[str, np.ndarray]]:
        """The bindings as ONE batched pass, whatever their number (the
        pass `run_many` takes from BATCH_MIN bindings on)."""
        bindings_list = list(bindings_list)
        if not self.param_spec:
            raise ValueError("a batched pass needs runtime parameters")
        return self._pass(bindings_list,
                          [check_bindings(self, b) for b in bindings_list])

    def _pass(self, bindings_list: list, merged: list[dict]) -> list:
        """One batched pass of the bindings (`merged`: their checked
        values), settled: replayed where `_pass_replay` can, else the
        eager vmapped walk."""
        run = self._pass_replay(merged)
        if run is None:
            return self._settle(bindings_list,
                                [self.execute_many(self.bind_many(merged))])
        return self._settle(bindings_list, [run],
                            release=self._pass_lock.release)

    def _pass_replay(self, merged: list[dict]):
        """The pass of `merged` through its CUDA graph, captured here on
        the first pass that `replays_pass` admits; the caller's settle
        releases `_pass_lock`, which this holds on return, once the
        counts and the frames are on the host.  None, with the lock free,
        where the pass is not admitted, finds the lock held, or its
        capture raised (counted and logged): the eager pass then."""
        if not replays_pass(len(merged), self.n_shards, self.device,
                            self.settings.compact_measure_only) \
                or not self._pass_lock.acquire(blocking=False):
            return None
        try:
            if self._pass_graph is None and self.pass_capture_error is None:
                try:
                    self._pass_graph = graphs.capture_pass(self, merged)
                except Exception as e:  # noqa: BLE001 - counted and logged
                    self.pass_capture_error = f"{type(e).__name__}: {e}"
                    graphs.failed(e)
            run = None if self._pass_graph is None \
                else self._pass_graph.replay(merged)
        except BaseException:
            self._pass_lock.release()
            raise
        if run is None:
            self._pass_lock.release()
            return None
        self.n_pass_replays += 1
        return run

    def bind_many(self, merged: list[dict]) -> dict:
        """The `param/<name>` inputs of a batched pass: each parameter's
        (N,) vector of its dtype, on the query's device, from one
        host-to-device copy of every parameter's bytes (`ParamBuffer`)."""
        buf = graphs.ParamBuffer(self.param_spec, len(merged), self.device)
        buf.write(merged)
        buf.send()
        return buf.inputs()

    def execute_many(self, pvec: dict):
        """The batched staged walk over `bind_many`'s parameter vectors:
        (columns, mask, per-point counts), each with the N bindings in
        front, on the device, nothing synchronized.  The resident inputs
        are closed over, so vmap maps the parameters alone.  Under a
        mesh: shard 0's columns and mask (every shard's are the same) and
        each point's counts as an `(N, n_shards)` tensor."""
        if self._mesh is None:
            resident = self.resident
            return torch.func.vmap(
                lambda p: self._walk({**resident, **p}, self.device),
                randomness="error")(pvec)
        return self._shard_zero(self.execute_shards_many(pvec))

    def execute_shards_many(self, pvec: dict) -> list:
        """The sharded batched walk: every shard's (columns, mask,
        counts), each with the N bindings in front, in rank order.  Each
        shard runs one staged walk under vmap in its thread, over its own
        resident blocks and `bind_many`'s parameter vectors (copied once
        to each other device of the mesh); its collectives take the
        first parameter as their token (`TorchBackend`)."""
        devs = self._mesh.devices
        on = {d: {k: v.to(d) for k, v in pvec.items()} for d in set(devs)}

        def shard(rank, group, blocks):
            dev = devs[rank]
            return torch.func.vmap(
                lambda p: self._walk({**blocks, **p}, dev, group, rank,
                                     next(iter(p.values()))),
                randomness="error")(on[dev])
        return self._mesh.run(shard, self.shard_resident)

    def _counts_to_host(self, runs: list) -> list[dict]:
        """The point counts of every binding of `runs` (this query's
        staged walks: a scalar walk is one binding, a batched pass one a
        slot of its leading axis) on the host, in ONE device-to-host copy
        for all of them (a copy each would wait on the device once a
        point): one dict a binding, in order, of Python ints, or under a
        mesh `(n_shards,)` int64 arrays.  A count can be a CPU scalar (a
        measure-only point over a frame with no mask)."""
        sizes = [_bindings(mask) for _out, mask, _c in runs]
        flat = [torch.as_tensor(c, device=self.device).reshape(-1)
                .to(torch.int64) for *_f, counts in runs
                for c in counts.values()]
        if not flat:
            return [{} for _ in range(sum(sizes))]
        with span("repro.counts"):
            vals = torch.cat(flat).cpu().numpy()
        k, at, out = self.n_shards, 0, []
        for (*_f, counts), n in zip(runs, sizes):
            got = [{} for _ in range(n)]
            for pid in counts:
                v = vals[at:at + n * k].reshape(n, k)
                for i in range(n):
                    got[i][pid] = v[i] if k > 1 else int(v[i, 0])
                at += n * k
            out += got
        return out

    def _settle(self, bindings_list: list, runs: list,
                counts: Optional[list] = None,
                release=None) -> list[dict[str, np.ndarray]]:
        """The results of `runs`, this query's staged walks under
        `bindings_list` (one scalar walk a binding, or one batched pass of
        them all), whose point counts are `counts` (read here, in one
        copy, if None).  In order: the counts are recorded; the frames of
        the bindings that fit are copied to the host and `runs` is
        emptied, so that their device memory is free before a re-run;
        `release` is called, also where a step before it raised; each of
        those bindings is decoded; and every binding whose capacity bucket
        overflowed (its compacted frames dropped rows) re-runs uncompacted
        in one `run_many` of the twin, whose probes report every site's
        TRUE count, folded back for the feedback store."""
        try:
            if counts is None:
                counts = self._counts_to_host(runs)
            bad = self.observations.record(counts, len(runs))
            host = _frames_to_host(runs, bad)
            runs.clear()
        finally:
            if release is not None:
                release()
        good = [i for i in range(len(bindings_list)) if i not in bad]
        results: list = [None] * len(bindings_list)
        for i, (cols, mask) in zip(good, host):
            results[i] = _decode_frame(cols, mask, self.out_meta)
        if bad:
            with span("repro.rerun"):
                twin = self._fallback_query()
                redo = twin.run_many([bindings_list[i] for i in bad])
            self.observations.merge(twin.observations)
            for i, r in zip(bad, redo):
                results[i] = r
        return results

    def input_nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.inputs.values()))


class CompiledQueryBatch:
    """Several plans run as one unit: every staged walk is enqueued back
    to back, the point counts of all of them are read in one copy, and
    each result is decoded.  `run()` returns the per-query results of
    `CompiledQuery.run()`, in order.  The members hold one set of
    resident inputs: an input key the plans share (lineitem's columns
    for q1 and q6) is copied to the device once, and `inputs` is the
    merged host dict, as the reference's (whose one XLA program shares
    the loads).  Unlike the reference, which trusts the key, the batch
    checks that the plans' host arrays under a shared key are
    byte-identical."""

    def __init__(self, plans, db: Database, settings: Settings,
                 device=None):
        if resolve_shards(settings, resolve_device(device)) != 1:
            # each member would need its own mesh run and its own
            # partitioned blocks, as in the reference, which rejects the
            # combination rather than half-supporting it
            raise NotImplementedError(
                "CompiledQueryBatch does not compose with sharded "
                "execution (Settings.shards != 1)")
        pool: dict = {}
        self.queries = []
        self.inputs: dict[str, np.ndarray] = {}
        for p in plans:
            q = CompiledQuery(p, db, settings, device=device, pool=pool)
            for k, v in q.inputs.items():
                have = self.inputs.get(k)
                if have is not None and not k.startswith("param/") \
                        and have is not v and not _same_bytes(have, v):
                    raise ValueError(f"input {k!r} differs between the "
                                     "batch's plans")
                self.inputs[k] = v
            self.queries.append(q)

    def run(self) -> list[dict[str, np.ndarray]]:
        runs = [q.execute(q.bind()) for q in self.queries]
        counts = self.queries[0]._counts_to_host(runs) if runs else []
        return [q._settle([None], [r], [c])[0]
                for q, r, c in zip(self.queries, runs, counts)]

    def input_nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.inputs.values()))


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _bindings(mask) -> int:
    """The bindings of a staged walk whose result mask is `mask`: a
    batched pass's leading axis, or a scalar walk's one."""
    return mask.shape[0] if mask.dim() > 1 else 1


def _frames_to_host(runs: list, bad: list[int]) -> list[tuple]:
    """(columns, mask) on the host of every binding of `runs` (numbered
    as `_counts_to_host` numbers them) that is not in `bad`, in order."""
    host, at = [], 0
    for out, mask, _c in runs:
        n = _bindings(mask)
        keep = [i for i in range(n) if at + i not in bad]
        if mask.dim() == 1:     # a scalar walk's frame has no binding axis
            keep = [None] * len(keep)
        host += _to_host(out, mask, keep)
        at += n
    return host


def _to_host(out: dict, mask, slots: list) -> list[tuple]:
    """The bindings `slots` of a result frame, each as (columns, mask) on
    the host: indices into the binding axis in front, or [None] for a
    scalar walk's frame, which has none.  A frame of more than
    `DEVICE_SELECT_ROWS` rows is cut to each binding's valid rows on the
    device (`valid_rows_to_host`); a smaller one is copied whole, every
    binding at once (`whole_to_host`)."""
    if not slots:
        return []
    with span("repro.result.copy"):
        if mask.shape[-1] > DEVICE_SELECT_ROWS:
            return [valid_rows_to_host(*_binding(out, mask, i))
                    for i in slots]
        cols, hmask = whole_to_host(out, mask)
    return [_binding(cols, hmask, i) for i in slots]


def _binding(cols: dict, mask, i) -> tuple:
    """Binding `i`'s columns and mask of a frame with the binding axis in
    front; the frame's own for None."""
    if i is None:
        return cols, mask
    return {k: v[i] for k, v in cols.items()}, mask[i]


def valid_rows_to_host(out, mask):
    """The result's columns as numpy arrays of its valid rows, selected
    on the device, and an all-true host mask over them."""
    idx = mask.nonzero().squeeze(1)
    cols = {k: v.index_select(0, idx).cpu().numpy() for k, v in out.items()}
    return cols, np.ones(idx.shape[0], dtype=bool)


def whole_to_host(out, mask):
    """The result's columns and mask copied whole, as numpy arrays."""
    return {k: v.cpu().numpy() for k, v in out.items()}, mask.cpu().numpy()


def _decode_frame(out, mask, out_meta) -> dict[str, np.ndarray]:
    with span("repro.result.decode"):
        res = {}
        for name, kind, table, colname in out_meta:
            v = out[name][mask]
            if kind == "codes":
                vocab = table.vocabs[colname]
                res[name] = vocab[np.clip(v, 0, None)].astype(str)
            elif kind in ("chars", "wordchars"):
                w = v.shape[1]
                b = np.ascontiguousarray(v).view(f"S{w}")[:, 0]
                res[name] = np.char.decode(
                    np.char.rstrip(b, b"\x00"), "ascii").astype(str)
            elif kind == "words":
                vocab = table.word_vocabs[colname]
                res[name] = np.array(
                    [" ".join(str(vocab[c]) for c in row if c >= 0)
                     for row in v])
            else:
                res[name] = v
        return res
