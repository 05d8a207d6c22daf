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
also accumulated per query (`observed_max`, underuse streaks) and
harvested by `PlanCache`'s feedback store, which re-plans capacities
from measured headroom after repeated overflows and shrinks them after
sustained underuse.

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
worst shard, and `observed_shard` keeps the per-shard maxima.  A
sharded `run_many` runs one sharded walk a binding (the reference
composes its batched form under the shard map; the port does not yet).
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.backend import TorchBackend
from repro_torch.core.expr import Param
from repro_torch.core.mesh import AXIS, data_mesh, resolve_shards
from repro_torch.core.operators import StageCtx, frame_nrows
from repro_torch.core.passes.param_binding import plan_params
from repro_torch.core.passes.pipeline import Settings, optimize
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
    substituted before construction — pass `bindings` to `optimize`."""

    # tiering.Runnable surface: a batch is vmapped staged walks (or
    # scalar ones below BATCH_MIN), never padded
    pads_batches = False

    def __init__(self, plan: ir.Plan, db: Database, settings: Settings,
                 params: Optional[dict] = None,
                 est_params: Optional[dict] = None,
                 observed: Optional[dict] = None,
                 device=None):
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
        self.n_overflows = 0      # executions (or batch slots) that fell back
        # staged walks run by run() / run_many(): one a batched pass
        self.n_executions = 0
        # feedback state, harvested by PlanCache: the all-time max true
        # count per point, and the current run of consecutive executions
        # with every point under a quarter of its capacity, with its
        # window max
        self._obs_lock = threading.Lock()
        self.observed_max: dict[str, int] = {}
        # per-shard all-time max vectors (shape (n_shards,)) — a sharded
        # walk reports every point's count per shard
        self.observed_shard: dict[str, np.ndarray] = {}
        self.under_streak = 0
        self.streak_max: dict[str, int] = {}
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

        spec = plan_params(self.plan)
        structural = sorted(n for n, i in spec.items() if i.structural)
        if structural:
            raise TypeError(
                f"compile-time parameters {structural} are unresolved; "
                "bind them via optimize(..., bindings=...)")
        self.param_spec: dict[str, str] = {n: i.dtype for n, i in spec.items()}
        self.param_defaults = {n: (params or {})[n] for n in self.param_spec
                               if n in (params or {})}
        missing = sorted(set(self.param_spec) - set(self.param_defaults))
        if missing:
            raise KeyError(f"no binding supplied for parameters {missing}")

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
            self.resident = {k: torch.from_numpy(v).to(self.device)
                             for k, v in self.inputs.items()
                             if not k.startswith("param/")}
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
        block s is rows [s*P, (s+1)*P) of its padded copy: a view of one
        tensor when every shard sits on one device, a copy on its shard's
        device otherwise.  A replicated input is copied once a device."""
        devs = self._mesh.devices
        n = self.n_shards
        one_device = len(set(devs)) == 1
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
            whole = torch.from_numpy(v).to(devs[0]) if one_device else None
            for s, d in enumerate(devs):
                lo, hi = s * rows, (s + 1) * rows
                blocks[s][k] = whole[lo:hi] if one_device else \
                    torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(d)
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
        it has not met yet.  The walks are not executions: nothing is
        observed or counted.  Returns (and keeps as `compile_time`) its
        seconds."""
        t0 = time.perf_counter()
        self.execute(self.bind())
        if self.param_spec and self._mesh is None:
            self.execute_many(self.bind_many([self.param_defaults]))
        self._synchronize()
        self.compile_time = time.perf_counter() - t0
        return self.compile_time

    # -- parameter binding -----------------------------------------------------
    def bind(self, params: Optional[dict] = None) -> dict:
        """Input dict for one execution: the resident columns plus the
        per-execution parameter scalars.  A non-None `params` must name
        *every* runtime parameter."""
        merged = self._check_bindings(params)
        inputs = dict(self.resident)
        for name, dtype in self.param_spec.items():
            inputs[f"param/{name}"] = np.asarray(merged[name], dtype=dtype)
        return inputs

    def _check_bindings(self, params: Optional[dict]) -> dict:
        if params is None:
            return self.param_defaults
        unknown = sorted(set(params) - set(self.param_spec))
        if unknown:
            raise KeyError(f"unknown parameters {unknown}; this plan "
                           f"takes {sorted(self.param_spec)}")
        missing = sorted(set(self.param_spec) - set(params))
        if missing:
            raise KeyError(f"no binding supplied for parameters "
                           f"{missing}")
        return params

    # -- execution -------------------------------------------------------------
    def execute(self, inputs: dict):
        """The staged walk: (columns, mask, per-point counts), all on the
        device, nothing synchronized.  Under a mesh: shard 0's columns and
        mask (every shard's are the same) and each point's counts as an
        `(n_shards,)` vector."""
        if self._mesh is None:
            return self._walk(inputs, self.device)
        shards = self.execute_shards(inputs)
        out, mask, counts = shards[0]
        dev = self._mesh.devices[0]
        return out, mask, {
            pid: torch.stack([torch.as_tensor(s[2][pid], device=dev)
                              .reshape(()) for s in shards])
            for pid in counts}

    def execute_shards(self, inputs: dict) -> list:
        """The sharded staged walk: every shard's (columns, mask, counts),
        in rank order.  `inputs` is `bind()`'s: the bound parameters; each
        shard reads its own resident blocks."""
        per = [{**blocks, **inputs} for blocks in self.shard_resident]
        devs = self._mesh.devices
        return self._mesh.run(
            lambda rank, group, inp: self._walk(inp, devs[rank], group, rank),
            per)

    def _walk(self, inputs: dict, device, group=None, rank: int = 0):
        ctx = StageCtx(self.db, self.settings,
                       TorchBackend(device, group, rank),
                       lambda key, make: inputs[key],
                       self.param_defaults, device=device, staged=True,
                       **self._mesh_ctx())
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

    def _merge_twin_observations(self, twin: "CompiledQuery") -> None:
        """Fold the twin's measured true counts into this query's
        observation state, where PlanCache's feedback step harvests
        them.  Max-merge: idempotent across repeated fallbacks."""
        with twin._obs_lock:
            obs = dict(twin.observed_max)
        with self._obs_lock:
            for pid, c in obs.items():
                if c > self.observed_max.get(pid, -1):
                    self.observed_max[pid] = c

    def _observe(self, slot_counts: list[dict], n_overflows: int,
                 executions: int) -> None:
        """Feedback accounting for a list of per-execution (or per-slot)
        true-count dicts, `n_overflows` of which overflowed, from
        `executions` staged walks: the execution and overflow counters,
        the all-time max per point, plus the consecutive-underuse streak
        and its window max (the shrink signal decays: a historical spike
        must not pin capacity up).  Under the lock: a server runs one
        query from several threads."""
        with self._obs_lock:
            self.n_executions += executions
            self.n_overflows += n_overflows
            for counts in slot_counts:
                oflow = False
                under = any(pid in self.point_caps for pid in counts)
                for pid, c in counts.items():
                    if c > self.observed_max.get(pid, -1):
                        self.observed_max[pid] = c
                    cap = self.point_caps.get(pid)
                    if cap is None:     # measure-only probe: count only
                        continue
                    if c > cap:
                        oflow = True
                    if 4 * c >= cap:
                        under = False
                if oflow or not under:
                    self.under_streak = 0
                    self.streak_max = {}
                else:
                    self.under_streak += 1
                    for pid, c in counts.items():
                        if c > self.streak_max.get(pid, -1):
                            self.streak_max[pid] = c

    def _overflowed(self, counts: dict) -> bool:
        return any(c > self.point_caps[pid] for pid, c in counts.items()
                   if pid in self.point_caps)

    def _counts_to_host(self, runs: list[dict]) -> list[dict]:
        """Every run's point counts on the host, in ONE device-to-host
        copy for all of them (a copy each would wait on the device once a
        point): Python ints, or under a mesh `(n_shards,)` int64 arrays.
        A count can be a CPU scalar (a measure-only point over a frame
        with no mask)."""
        flat = [torch.as_tensor(c, device=self.device).reshape(-1)
                .to(torch.int64) for counts in runs for c in counts.values()]
        if not flat:
            return [{} for _ in runs]
        vals = torch.cat(flat).cpu().numpy()
        k, at, out = self.n_shards, 0, []
        for counts in runs:
            got = {}
            for pid in counts:
                v = vals[at:at + k]
                got[pid] = v if k > 1 else int(v[0])
                at += k
            out.append(got)
        return out

    def _observe_shards(self, runs: list[dict]) -> None:
        """Elementwise-max merge of per-shard count vectors (shape
        (n_shards,)) into the all-time per-shard state."""
        with self._obs_lock:
            for vecs in runs:
                for pid, v in vecs.items():
                    old = self.observed_shard.get(pid)
                    self.observed_shard[pid] = \
                        v.copy() if old is None else np.maximum(old, v)

    def _result(self, out, mask) -> dict[str, np.ndarray]:
        copy = valid_rows_to_host if mask.shape[0] > DEVICE_SELECT_ROWS \
            else whole_to_host
        return _decode_frame(*copy(out, mask), self.out_meta)

    def _settle(self, bindings_list: list, runs: list,
                counts: list[dict]) -> list[dict[str, np.ndarray]]:
        """The results of `runs`, this query's staged walks under
        `bindings_list`, whose point counts `counts` are on the host:
        the counts are observed, every slot whose capacity bucket
        overflowed re-runs uncompacted through the twin (its compacted
        frames dropped rows; the twin's probes report every site's TRUE
        count, folded back for the feedback store), and the rest are
        decoded.  Under a mesh the per-shard vectors are kept in
        `observed_shard`, and the rest keys off the worst shard."""
        if self.n_shards > 1:
            self._observe_shards(counts)
            counts = [{pid: int(v.max()) for pid, v in c.items()}
                      for c in counts]
        bad = [i for i, c in enumerate(counts) if self._overflowed(c)]
        self._observe(counts, len(bad), len(runs))
        results = [None if i in bad else self._result(out, mask)
                   for i, (out, mask, _c) in enumerate(runs)]
        return self._rerun(bindings_list, bad, results)

    def _rerun(self, bindings_list: list, bad: list[int],
               results: list) -> list:
        """Fill the overflowing slots `bad` of `results` from the twin:
        one `run_many` of their bindings (the compacted frames dropped
        rows; the twin's probes report every site's TRUE count, folded
        back for the feedback store)."""
        if bad:
            twin = self._fallback_query()
            redo = twin.run_many([bindings_list[i] for i in bad])
            self._merge_twin_observations(twin)
            for i, r in zip(bad, redo):
                results[i] = r
        return results

    def run(self, params: Optional[dict] = None) -> dict[str, np.ndarray]:
        """One binding through the scalar staged walk (parameters as host
        scalars)."""
        return self._walks([params])[0]

    def _walks(self, bindings_list: list) -> list[dict[str, np.ndarray]]:
        """One scalar staged walk a binding, enqueued back to back, their
        point counts read in one copy, then settled."""
        runs = [self.execute(self.bind(b)) for b in bindings_list]
        return self._settle(bindings_list, runs, self._counts_to_host(
            [c for *_f, c in runs]))

    def run_many(self, bindings_list) -> list[dict[str, np.ndarray]]:
        """N bindings as batched passes (the module docstring): each pass
        one staged walk under vmap of at most BATCH_MAX bindings (the
        passes of one call differ in size by one at most), its
        (N,) point counts read in one copy, then each slot decoded; below
        BATCH_MIN bindings, and on a mesh, one scalar walk a binding.
        Returns one result per binding, in order, each equal to
        `run(bindings_list[i])`; a None binding means the construction-
        time bindings.  Only overflowing slots re-run, through the twin.
        A plan with no runtime parameters runs once and returns
        independent copies (a caller may mutate its result in place)."""
        bindings_list = list(bindings_list)
        merged = [self._check_bindings(b) for b in bindings_list]
        if not bindings_list:
            return []
        if not self.param_spec:
            res = self.run(bindings_list[0])
            return [res] + [{k: np.copy(v) for k, v in res.items()}
                            for _ in bindings_list[1:]]
        if self._mesh is not None or len(merged) < BATCH_MIN:
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
        if not self.param_spec or self._mesh is not None:
            raise ValueError("a batched pass needs runtime parameters and "
                             "no mesh")
        return self._pass(bindings_list,
                          [self._check_bindings(b) for b in bindings_list])

    def _pass(self, bindings_list: list, merged: list[dict]) -> list:
        """One batched pass of the bindings (`merged`: their checked
        values), settled: the slots that overflowed re-run through the
        twin."""
        out, mask, counts = self.execute_many(self.bind_many(merged))
        slot_counts = self._batch_counts_to_host(counts, len(merged))
        bad = [i for i, c in enumerate(slot_counts) if self._overflowed(c)]
        self._observe(slot_counts, len(bad), 1)
        good = sorted(set(range(len(merged))) - set(bad))
        results: list = [None] * len(merged)
        for i, r in zip(good, self._results_many(out, mask, good)):
            results[i] = r
        del out, mask
        return self._rerun(bindings_list, bad, results)

    def bind_many(self, merged: list[dict]) -> dict:
        """The `param/<name>` inputs of a batched pass: each parameter's
        (N,) vector of its dtype, on the query's device, from one
        host-to-device copy of every parameter's bytes (wider dtypes
        first, so that each vector starts aligned to its item)."""
        names = sorted(self.param_spec,
                       key=lambda n: -np.dtype(self.param_spec[n]).itemsize)
        arrays = [np.asarray([m[n] for m in merged],
                             dtype=self.param_spec[n]) for n in names]
        raw = torch.from_numpy(np.concatenate(
            [a.view(np.uint8) for a in arrays])).to(self.device)
        out, at = {}, 0
        for name, a in zip(names, arrays):
            out[f"param/{name}"] = raw[at:at + a.nbytes].view(
                getattr(torch, a.dtype.name))
            at += a.nbytes
        return out

    def execute_many(self, pvec: dict):
        """The batched staged walk over `bind_many`'s parameter vectors:
        (columns, mask, per-point counts), each with the N bindings in
        front, on the device, nothing synchronized.  The resident inputs
        are closed over, so vmap maps the parameters alone."""
        resident = self.resident
        return torch.func.vmap(
            lambda p: self._walk({**resident, **p}, self.device),
            randomness="error")(pvec)

    def _batch_counts_to_host(self, counts: dict, n: int) -> list[dict]:
        """Every slot's point counts from the batched walk's (N,) vectors
        in ONE device-to-host copy."""
        if not counts:
            return [{} for _ in range(n)]
        vals = torch.stack([torch.as_tensor(c, device=self.device)
                            .reshape(n).to(torch.int64)
                            for c in counts.values()]).cpu().numpy()
        return [{pid: int(vals[k, i]) for k, pid in enumerate(counts)}
                for i in range(n)]

    def _results_many(self, out: dict, mask, slots: list[int]) -> list:
        """The decoded results of the batched walk's `slots`.  A frame
        the result copy would cut on the device is cut a slot at a time;
        a smaller one is copied whole, every slot at once."""
        if not slots:
            return []
        if mask.shape[1] > DEVICE_SELECT_ROWS:
            return [self._result({k: v[i] for k, v in out.items()}, mask[i])
                    for i in slots]
        host, hmask = whole_to_host(out, mask)
        return [_decode_frame({k: v[i] for k, v in host.items()}, hmask[i],
                              self.out_meta) for i in slots]

    def input_nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.inputs.values()))


class CompiledQueryBatch:
    """Several plans run as one unit: every staged walk is enqueued back
    to back, the point counts of all of them are read in one copy, and
    each result is decoded.  `run()` returns the per-query results of
    `CompiledQuery.run()`, in order.  (The reference stages the plans
    into one XLA program, whose compiler can share their common loads;
    eager torch has no such scope, so each query keeps its own resident
    inputs.)"""

    def __init__(self, plans, db: Database, settings: Settings,
                 device=None):
        if resolve_shards(settings, resolve_device(device)) != 1:
            # each member would need its own mesh run and its own
            # partitioned blocks; nothing is shared across members either
            # way, so the combination is rejected rather than
            # half-supported
            raise NotImplementedError(
                "CompiledQueryBatch does not compose with sharded "
                "execution (Settings.shards != 1)")
        self.queries = [CompiledQuery(p, db, settings, device=device)
                        for p in plans]

    def run(self) -> list[dict[str, np.ndarray]]:
        runs = [q.execute(q.bind()) for q in self.queries]
        counts = self.queries[0]._counts_to_host(
            [c for *_f, c in runs]) if self.queries else []
        return [q._settle([None], [r], [c])[0]
                for q, r, c in zip(self.queries, runs, counts)]

    def input_nbytes(self) -> int:
        return sum(q.input_nbytes() for q in self.queries)


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
    res = {}
    for name, kind, table, colname in out_meta:
        v = out[name][mask]
        if kind == "codes":
            res[name] = table.vocabs[colname][np.clip(v, 0, None)].astype(str)
        elif kind == "chars":
            w = v.shape[1]
            b = np.ascontiguousarray(v).view(f"S{w}")[:, 0]
            res[name] = np.char.decode(
                np.char.rstrip(b, b"\x00"), "ascii").astype(str)
        elif kind == "words":
            vocab = table.word_vocabs[colname]
            res[name] = np.array(
                [" ".join(str(vocab[c]) for c in row if c >= 0)
                 for row in v])
        elif kind == "wordchars":
            w = v.shape[1]
            b = np.ascontiguousarray(v).view(f"S{w}")[:, 0]
            res[name] = np.char.decode(
                np.char.rstrip(b, b"\x00"), "ascii").astype(str)
        else:
            res[name] = v
    return res
