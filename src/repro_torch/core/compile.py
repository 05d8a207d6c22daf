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
bet whose worst case is latency, never wrong results.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.backend import TorchBackend
from repro_torch.core.expr import Param
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


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; there is no silent CPU path — a caller
    who wants the CPU asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CompiledQuery runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class CompiledQuery:
    """A staged query, resident on `device`.  `params` supplies bindings
    for every runtime (numeric) Param left residual in the optimized plan;
    they are also the values used during the collection walk.
    Compile-time params (string values, Limit.n) must have been
    substituted before construction — pass `bindings` to `optimize`."""

    def __init__(self, plan: ir.Plan, db: Database, settings: Settings,
                 params: Optional[dict] = None,
                 est_params: Optional[dict] = None,
                 observed: Optional[dict] = None,
                 device=None):
        self.device = resolve_device(device)
        self.db = db
        self.settings = settings
        # compaction plants static-capacity points from cardinality
        # *estimates*; keep a pristine copy of the logical plan so an
        # estimate that undershoots at runtime can build the uncompacted
        # twin lazily.  A measure-only twin plants nothing that can
        # overflow, so it needs no fallback of its own.
        pristine = copy.deepcopy(plan) \
            if (settings.compaction and not settings.compact_measure_only) \
            or any(isinstance(n, ir.Compact) and n.capacity > 0
                   for n in ir.walk(plan)) else None
        self.plan = optimize(plan, db, settings,
                             est_params=est_params if est_params is not None
                             else (params or {}),
                             observed=observed)
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
        self.point_caps = {n.point_id: int(n.capacity) for n in real}
        self._pristine = pristine if real else None
        self._fallback: Optional["CompiledQuery"] = None
        self._fallback_lock = threading.Lock()
        self.n_overflows = 0      # executions that fell back

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
                           staged=False)
        sample_frame = sampler.stage(self.plan)
        self.out_meta = [(name, b.kind, b.table, b.col)
                         for name, b in sample_frame.cols.items()]
        # a dead-but-declared param must still be an input of the program
        for name, dtype in self.param_spec.items():
            sampler.param(Param(name, dtype))

        # 2. the resident inputs: every base column and index structure is
        #    copied to the device once, here; params are bound per run
        self.resident = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.inputs.items()
                         if not k.startswith("param/")}

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
        device, nothing synchronized."""
        ctx = StageCtx(self.db, self.settings, TorchBackend(self.device),
                       lambda key, make: inputs[key],
                       self.param_defaults, device=self.device, staged=True)
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
        out, mask, counts = self.execute(self.bind(params))
        if self.point_caps:
            counts = {pid: int(c) for pid, c in counts.items()}
            if any(c > self.point_caps[pid] for pid, c in counts.items()
                   if pid in self.point_caps):
                # a capacity bucket overflowed: the compacted frames
                # dropped rows, so the outputs are unusable — re-execute
                # uncompacted
                self.n_overflows += 1
                return self._fallback_query().run(params)
        copy = valid_rows_to_host if mask.shape[0] > DEVICE_SELECT_ROWS \
            else whole_to_host
        return _decode_frame(*copy(out, mask), self.out_meta)

    def input_nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.inputs.values()))


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
