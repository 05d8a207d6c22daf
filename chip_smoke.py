#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # TPC-H SF 1, seed 0, on CUDA device 0

Phases (any failure raises; the script then exits non-zero and prints no
result line):

  1. print the card's name and power limit (nvidia-smi);
  2. generate TPC-H at SF 1 and run all 15 queries at `opt` and
     `opt-pallas` on the CPU — the port's own reference answers — and the
     row layout of q1, q6, q12 and q19 at `opt-pallas`, while recording
     the operands the opt-pallas plans hand to each kernel (those of q1,
     q3, q6 and q12 feed phases 4 and 4b);
  3. build every kernel library, every generated instance phase 5 reaches
     among them (one nvcc per source, all at once);
  4. hold each kernel against its plain torch version on the card, at the
     recorded SF 1 shapes and at edge cases (1 and 37 rows, no valid row,
     overflow past the capacity, translate), and compaction under many
     tiles (2^22 + 37 rows at densities 0, 0.5 and 1, capacity below and
     above the count, with and without translate, each call 20 times, for
     a race in the look-back scan), for the mask and for a predicate
     evaluated inside the scan; filter_agg called twice at each recorded
     shape, whose sums must be bit-identical (register regime); the
     selective kernel at q6's shape twice, bit-identical, and 20 calls
     back to back at 1, 37 and 908,340 rows (the fold's ticket reset),
     each against the plain version; a NaN in a row the mask drops and
     an infinity in a kept row through filter_agg and the generated
     selective kernel, at G = 3 and 9, bit for bit against the plain
     version and the oracle; the shapes one launch cannot take (17 sums
     beside l_returnflag through the engine at opt-pallas, against the
     CPU answer; a dense G = 4096, A = 14 call, against the plain
     version); time kernel, plain version and, where one exists, a
     single PyTorch call computing the same function, and require one
     kernel a call (compact_pred with its memset, the selective form at
     capacity 0);
  4b. the kernel library's surface (`repro_torch.kernels`), whose
     gather_join, masked_topk and capacity form of selective_filter_agg
     the engine never calls: reset their launch counters, drive each entry
     point once at SF 1 shapes (customer and lineitem keys into random
     tables, l_extendedprice under q3's shipdate mask, q6's operands with
     a compaction capacity, the matrix filter_agg at q1's operands,
     compact_translate at q3's), read the counters, then hold every
     output and edge case against the plain versions — among them a
     predicate with a float32 subnormal literal, which a build that
     flushed subnormals to zero would get wrong, and top-k over 40,000
     rows of special values (+-0, +-NaN with payloads, +-inf, subnormals,
     -3e38; all rows masked, all equal, k > n) at k = 1, 10 and 1,024,
     which must give the plain version's ids and bit patterns, and
     gather_join at C = 1, 2, 3 and 5 with fk a view at an odd offset
     and NaN and infinity in the table, in both of its ways to read the
     table, bit for bit — and time them, gather_join at 10,000 x 3 also
     with each way forced;
  5. reset the launch counters and run the engine's ladder on the card
     through `CompiledQuery(...).run()`: all 15 queries at `opt` and
     `opt-pallas`, each against its CPU answer; at `naive`, `template`,
     `tpch` and `strdict`, each against the CPU answer at `opt`; the row
     layout of q1, q6, q12 and q19 at `naive`, `opt` and `opt-pallas`.
     Require every engine kernel to have launched, none outside
     opt-pallas, every opt-pallas run to launch exactly what the
     reference's plan calls at SF 1 (`LAUNCHES_SF1`: q4 filter_agg 1, q7
     compact 1, q9full filter_agg 1, ...; tests/test_torch_sf1_launches.py
     counts them in the reference), and no overflow at opt or opt-pallas.
     Time every query and rung (median and minimum of 5 runs after one
     warm-up, `run()` and the device program alone), freeing each query
     before the next;
  7. reset the launch counters and drive the serving path on the card at
     opt-pallas through its entry points (`PlanCache.execute`,
     `execute_many`, `execute_tiered`, `QueryServer.serve_batch`,
     `run_chaos`): (a) the six parameterized queries, default then
     alternative bindings, each against a CPU plan cache's answer at
     opt, one staging a shape, no library built by the rebind, the
     launches `LAUNCHES_SF1_PARAM` requires, cold (staging, `compile()`
     and first run) and warm times, and a specialized binding's own
     build; (b) `execute_many` of 1, 4 and 16 bindings of q6 and q12
     and the entry's own `run_many` of the same, each slot against
     `run`, all three timed; (c) a hand-planted 64-row compaction point
     that overflows: the twin's answer, the true count observed, one
     re-plan that stages once and then no overflow; (d) a tiered cache:
     request 1 from the oracle, then the promoted opt-pallas tier, equal
     answers; (e) a query server over 48 mixed requests: all resolved,
     its statistics balanced, one staging a shape; (f) the chaos
     harness: every future resolved, balanced, retried faults served,
     no drift from the port's Volcano; (g) warm state saved and loaded;
     (h) the peak device memory of the phase, and that closing every
     cache and server gives its memory back.  Require every engine
     kernel to have launched;
  8. the sharded path: all 15 queries at opt and opt-pallas on a 2-shard
     data mesh and at opt-pallas on a 4-shard one (`Settings.shards`;
     the shards sit on as many CUDA devices when the machine has them,
     else on virtual slots of cuda:0, and the phase prints which), each
     run twice against phase 5's unsharded card answer, every shard's
     output bit for bit the same, no overflow, the Exchange count of the
     port's CPU plan, at opt-pallas each engine call a launch of its
     kernel and none at opt; at opt-pallas, the largest call of each
     (query, entry point) in a query's first run, on one shard's card
     tensors, held against the plain version with phase 4's tolerances
     (the per-shard shapes: padded blocks, the sharded scan's mask,
     per-shard capacities); the median of 3 `run()`s beside phase 5's
     unsharded median (a record only: one card cannot gain from shards);
  9. the port's plan fuzzer (`repro_torch.core.analysis.fuzz.run_fuzz`)
     on the card at sf 0.05: 24 seeded plans through every `optimize()`
     rung (opt-shard over 4 virtual slots), `naive` and `opt` compiled
     against the port's Volcano, the first 4 also at opt-pallas; no
     failure;
  6. print one `{"kernels": [...]}` line (`launches` from phase 5,
     `serving_launches` from phase 7, `sharded_launches` from phase 8's
     opt-pallas runs, `sharded_rows` and `sharded_max_abs_err` from its
     kernel checks), and last the result line.

Every timed kernel shape is also profiled over 10 calls
(`torch.profiler`): `device_ms` (device time of its kernels and memsets
per call) and `kernels_per_call` stand beside the event-timed `ms`, and
for the four engine kernels `host_ms` (host clock around 100 calls with
no synchronisation inside, per call: the wrapper's own cost).

Tolerances: integer outputs (row ids, counts, slots), gathers and top-k
values must match exactly (top-k values bit for bit).
Float sums may differ in summation order (the kernels add per thread,
warp and block in a fixed order, or with shared-memory atomics above the
register regime; the plain versions add with `index_add_`), so they are
held to rtol 1e-3, atol 1e-3, except where a check says bit for bit;
query answers to the repo's `assert_same` rule (rtol 2e-3, atol 1e-2).

`--rehearse` runs the same phases on the CPU (plain versions only, no
build, no launch checks) at `--sf`, to test the script without a card;
it prints no result line.  On the card the script runs at SF 1, seed 0
only, the size its launch table holds.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# the queries whose kernel operands phase 4 holds against the plain
# versions; phase 5 runs every query of the port
SLICE = ["q1", "q3", "q6", "q12"]
PRESETS = ["opt", "opt-pallas"]
# the rest of the ladder, each held against the CPU answer at opt
LOWER_RUNGS = ["naive", "template", "tpch", "strdict"]
# the row layout where the generated kernels read strided columns
ROW_QUERIES = ["q1", "q6", "q12", "q19"]
ROW_RUNGS = ["naive", "opt", "opt-pallas"]
# kernel launches of each query at opt-pallas, TPC-H SF 1, seed 0: the
# reference's kernel entry calls while its plan is traced, one launch a
# call at these shapes; the row layout of ROW_QUERIES launches the same
# (tests/test_torch_sf1_launches.py holds the reference to this table)
LAUNCHES_SF1 = {
    "q1": {"filter_agg": 1},
    "q3": {"compact": 2, "compact_pred": 1},
    "q4": {"filter_agg": 1},
    "q5": {"compact": 1, "filter_agg": 1},
    "q6": {"selective_filter_agg": 1},
    "q7": {"compact": 1},
    "q9": {"filter_agg": 1},
    "q9full": {"filter_agg": 1},
    "q10": {"compact": 1},
    "q12": {"compact_pred": 1, "filter_agg": 1},
    "q13": {"filter_agg": 1},
    "q14": {"filter_agg": 1},
    "q17": {"compact_pred": 1, "filter_agg": 1},
    "q18": {},
    "q19": {"filter_agg": 1},
}
# kernel launches of one execution of each parameterized plan
# (`PARAM_QUERIES`) at opt-pallas, TPC-H SF 1, seed 0, its capacities
# planned for the default bindings: the reference's kernel entry calls
# while its plan is traced under the default and the alternative bindings
# alike (one program serves both; tests/test_torch_sf1_launches.py holds
# the reference to this table)
LAUNCHES_SF1_PARAM = {
    "q1": {"selective_filter_agg": 1},
    "q3": {"compact": 2, "compact_pred": 1},
    "q6": {"selective_filter_agg": 1},
    "q12": {"compact_pred": 1, "filter_agg": 1},
    "q14": {"filter_agg": 1},
    "q19": {"filter_agg": 1},
}
RUNS = 5                         # timed runs of each query, after a warm-up
SORT_INSENSITIVE = {"q3", "q10", "q18"}
KERNEL_TOL = dict(rtol=1e-3, atol=1e-3)
REPLACES = {
    "compact": "src/repro/kernels/compact.py:98",
    "compact_pred": "src/repro/kernels/compact.py:158",
    "filter_agg": "src/repro/kernels/filter_agg.py:58",
    "selective_filter_agg": "src/repro/kernels/filter_agg.py:156",
    "gather_join": "src/repro/kernels/gather_join.py:36",
    "masked_topk": "src/repro/kernels/topk.py:38",
    "selective_filter_agg_capacity": "src/repro/kernels/filter_agg.py:156",
}
SOURCES = {
    "compact": "src/repro_torch/kernels/csrc/compact.cuh",
    "compact_pred": "src/repro_torch/kernels/csrc/compact.cuh",
    "filter_agg": "src/repro_torch/kernels/csrc/filter_agg.cuh",
    "selective_filter_agg": "src/repro_torch/kernels/csrc/filter_agg.cuh",
    "gather_join": "src/repro_torch/kernels/csrc/gather_join.cu",
    "masked_topk": "src/repro_torch/kernels/csrc/topk.cu",
    "selective_filter_agg_capacity":
        "src/repro_torch/kernels/csrc/filter_agg.cuh",
}
ENGINE_KERNELS = ["compact", "compact_pred", "filter_agg",
                  "selective_filter_agg"]
LIBRARY_KERNELS = ["gather_join", "masked_topk",
                   "selective_filter_agg_capacity"]
SUBNORMAL = 1.1754944e-39        # a float32 subnormal: 2**-126 / 10
PROFILED = ("device_ms", "kernels_per_call", "memsets_per_call",
            "device_kernels")
# engine kernels that must be one launch a call: memsets beside it
ONE_KERNEL = {"compact_pred": 1, "selective_filter_agg": 0}


def log(*a):
    print(*a, flush=True)


def kmod(name: str):
    """A kernel module of the port.  Imported by its full name: the
    package exports functions under the names `compact`, `filter_agg`
    and `gather_join`."""
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}")


class CheckFailed(Exception):
    pass


def check(cond, what) -> None:
    """A check of the run (kept under `python -O`, unlike assert)."""
    if not cond:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# answers
# ---------------------------------------------------------------------------

def assert_same(a: dict, b: dict, sort_insensitive: bool, what: str):
    """The repo's answer comparison: same columns and rows, exact on ints,
    rtol 2e-3 / atol 1e-2 on floats, rows sorted first when the query's
    order may differ under float ties."""
    import numpy as np

    check(set(a) == set(b), f"{what}: columns differ")

    def canon(res):
        names = sorted(res)
        if not sort_insensitive:
            return {k: res[k] for k in names}
        keys = [np.round(res[k].astype(np.float64), 2)
                if res[k].dtype.kind == "f" else res[k] for k in names]
        order = np.lexsort(tuple(reversed(keys)))
        return {k: res[k][order] for k in names}

    ca, cb = canon(a), canon(b)
    for k in ca:
        va, vb = ca[k], cb[k]
        check(len(va) == len(vb), f"{what}.{k}: {len(va)} vs {len(vb)} rows")
        if va.dtype.kind == "f" or vb.dtype.kind == "f":
            check(np.isfinite(va.astype(np.float64)).all(), f"{what}.{k}")
            np.testing.assert_allclose(
                va.astype(np.float64), vb.astype(np.float64),
                rtol=2e-3, atol=1e-2, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_array_equal(va, vb, err_msg=f"{what}.{k}")


# ---------------------------------------------------------------------------
# phase 2: CPU answers + the operands each kernel sees
# ---------------------------------------------------------------------------

# the engine's kernel entry points in `repro_torch.kernels.ops`
ENTRY_POINTS = ["filter_agg_query", "compact_query", "compact_pred_query",
                "selective_agg_query"]


def cpu_answers(db, queries):
    """Run every query at opt and opt-pallas on the CPU, and the row
    layout at opt-pallas for ROW_QUERIES; record every kernel entry
    point's arguments under opt-pallas as (query, entry, args, kwargs),
    the row layout's with the query named `<q>/row`."""
    import dataclasses

    import repro_torch.kernels.ops as kops
    from repro_torch.core import CompiledQuery, preset

    calls = []
    names = ENTRY_POINTS
    saved = {n: getattr(kops, n) for n in names}
    current = [None]

    def recorder(name, fn):
        def g(*a, **k):
            calls.append((current[0], name, a, k))
            return fn(*a, **k)
        return g

    answers = {}
    runs = [(q, p, "column") for q in queries for p in PRESETS] \
        + [(q, "opt-pallas", "row") for q in ROW_QUERIES]
    for n in names:
        setattr(kops, n, recorder(n, saved[n]))
    try:
        for q, p, layout in runs:
            current[0] = None if p != "opt-pallas" else \
                q if layout == "column" else f"{q}/row"
            t0 = time.perf_counter()
            cq = CompiledQuery(queries[q](), db, dataclasses.replace(
                preset(p), layout=layout), device="cpu")
            got = cq.run()
            check(cq.n_overflows == 0, (q, p, layout))
            if layout == "column":
                answers[q, p] = got
            else:
                assert_same(got, answers[q, p], q in SORT_INSENSITIVE,
                            f"cpu {q} {p} row")
            log(f"cpu {q} {p} {layout}: {time.perf_counter() - t0:.2f} s")
    finally:
        for n in names:
            setattr(kops, n, saved[n])
    return answers, [c for c in calls if c[0] is not None]


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def to(dev, x, copy: bool = False):
    """`x` with every tensor in it on `dev` (copied even there when
    `copy`)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=copy)
    if isinstance(x, dict):
        return {k: to(dev, v, copy) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to(dev, v, copy) for v in x)
    return x


def time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    between CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def host_ms(fn, calls: int = 100) -> float:
    """The host's time per call of `fn`: `time.perf_counter` around
    `calls` back-to-back calls with no synchronisation inside, after a
    warm-up (the launches queue on the device meanwhile)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / calls * 1e3


def profile_call(fn, calls: int = 10) -> dict:
    """Device time and device operations per call of `fn` over `calls`
    calls under torch.profiler, after a warm-up: `device_ms` sums the
    device time of its kernels and memsets; `kernels_per_call` counts
    kernel launches, `memsets_per_call` memsets; `device_kernels` gives
    each one's device ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    memsets = [e for e in dev if e.key.startswith("Memset")]
    kernels = [e for e in dev if not e.key.startswith(("Memset", "Memcpy"))]
    return {"device_ms": sum(e.self_device_time_total for e in dev)
            / 1e3 / calls,
            "kernels_per_call": sum(e.count for e in kernels) / calls,
            "memsets_per_call": sum(e.count for e in memsets) / calls,
            "device_kernels": {e.key[:60]: e.self_device_time_total / 1e3
                               / calls for e in dev}}


def max_err(got, want, what: str, exact: bool = False) -> float:
    """Max |got - want| over matching outputs; ints (and floats when
    `exact`) must be equal, other floats within KERNEL_TOL."""
    import torch

    check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} outputs")
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach(), w.detach()
        check(g.shape == w.shape, f"{what}[{k}]: {g.shape} vs {w.shape}")
        check(g.dtype == w.dtype, f"{what}[{k}]: {g.dtype} vs {w.dtype}")
        if g.numel() == 0:
            continue
        if g.dtype.is_floating_point and not exact:
            check(torch.isfinite(g).all(), f"{what}[{k}] not finite")
            check(torch.allclose(g, w, **KERNEL_TOL),
                  f"{what}[{k}]: max err {(g - w).abs().max().item()}")
        else:
            check(torch.equal(g, w), f"{what}[{k}] differs")
        err = max(err, (g.double() - w.double()).abs().max().item())
    return err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_checks(records, dev, timed: bool):
    """One entry per kernel: max error over every check, times and bound
    at the SF 1 shape of the slice (the largest recorded call)."""
    import torch

    kc, kf = kmod("compact"), kmod("filter_agg")

    out = {}

    def note(name, err, shape_bytes, n, timers):
        e = out.setdefault(name, {"max_abs_err": 0.0, "n": -1})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        if timers is not None and n > e["n"]:
            e["n"] = n
            e["bytes"] = shape_bytes
            e.update({k: (time_ms(f) if (f is not None and timed) else None)
                      for k, f in timers.items()})
            if timed:
                e["host_ms"] = host_ms(timers["ms"])
                e.update(one_kernel_a_call(name, timers["ms"],
                                           ONE_KERNEL[name])
                         if name in ONE_KERNEL else profile_call(timers["ms"]))
                log(f"{name} at {n} rows: {e['ms']} ms, host "
                    f"{e['host_ms']} ms, device "
                    f"{json.dumps(e['device_kernels'])}")

    for q, entry, a, k in records:
        a, k = to(dev, a), to(dev, k)
        if entry == "filter_agg_query":
            mask, gidx, vals, G = a
            gidx = gidx.to(torch.int32)
            vals = [v.to(torch.float32) for v in vals]
            got = kf.filter_agg(mask, gidx, vals, G)
            want = kf.filter_agg_plain(mask, gidx, vals, G)
            err = max_err(got, want, f"filter_agg {q}")
            A = len(vals)
            # the main path's shapes aggregate in registers: a second
            # call must give the same sums bit for bit
            again = kf.filter_agg(mask, gidx, vals, G)
            check(torch.equal(got[0], again[0])
                  and torch.equal(got[1], again[1]),
                  f"filter_agg {q}: two calls differ")
            log(f"filter_agg {q} (G={G}, A={A}, {mask.shape[0]} rows): "
                "two calls bit-identical")
            # a count-only call (A = 0) has no index_add_ counterpart
            vm = torch.where(mask[:, None], torch.stack(vals, 1), 0.0) \
                if A else None
            lib_out = torch.zeros((G, A), device=mask.device)
            note("filter_agg", err,
                 nbytes(mask, gidx, *vals) + 4 * G * (A + 1),
                 mask.shape[0], {
                     "ms": lambda: kf.filter_agg(mask, gidx, vals, G),
                     "plain_ms": lambda: kf.filter_agg_plain(mask, gidx,
                                                             vals, G),
                     "library_ms": (lambda: lib_out.index_add_(0, gidx, vm))
                     if A else None})
        elif entry == "compact_query":
            mask, cap = a
            tr = k.get("translate", False)
            got = kc.compact(mask, cap, translate=tr)
            want = kc.compact_plain(mask, cap, tr)
            err = max_err(got, want, f"compact {q}")
            n = mask.shape[0]
            note("compact", err,
                 nbytes(mask) + 4 * cap + 4 + (4 * n if tr else 0), n, {
                     "ms": lambda: kc.compact(mask, cap, translate=tr),
                     "plain_ms": lambda: kc.compact_plain(mask, cap, tr),
                     "library_ms": lambda: torch.nonzero(mask)})
        elif entry == "compact_pred_query":
            cols, scalars, pred_fn, cap = a
            tr = k.get("translate", False)
            got = kc.compact_pred(cols, scalars, pred_fn, cap, translate=tr)
            want = kc.compact_pred_plain(cols, scalars, pred_fn, cap, tr)
            err = max_err(got, want, f"compact_pred {q}")
            n = next(iter(cols.values())).shape[0]
            note("compact_pred", err,
                 nbytes(*cols.values()) + 4 * cap + 4 + (4 * n if tr else 0),
                 n, {
                     "ms": lambda: kc.compact_pred(cols, scalars, pred_fn,
                                                   cap, translate=tr),
                     "plain_ms": lambda: kc.compact_pred_plain(
                         cols, scalars, pred_fn, cap, tr),
                     "library_ms": None})
        elif entry == "selective_agg_query":
            cols, scalars, pred_fn, value_fns, gidx_fn, G = a
            got = kf.selective_filter_agg(cols, scalars, pred_fn, value_fns,
                                          gidx_fn, G)
            want = kf.selective_filter_agg_plain(cols, scalars, pred_fn,
                                                 value_fns, gidx_fn, G)
            err = max_err(got, want, f"selective_filter_agg {q}")
            again = kf.selective_filter_agg(cols, scalars, pred_fn,
                                            value_fns, gidx_fn, G)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"selective_filter_agg {q}: two calls differ")
            n = next(iter(cols.values())).shape[0]
            A = len(value_fns)
            log(f"selective_filter_agg {q} (G={G}, A={A}, {n} rows): two "
                "calls bit-identical")
            note("selective_filter_agg", err,
                 nbytes(*cols.values()) + 4 * G * (A + 1) + 4, n, {
                     "ms": lambda: kf.selective_filter_agg(
                         cols, scalars, pred_fn, value_fns, gidx_fn, G),
                     "plain_ms": lambda: kf.selective_filter_agg_plain(
                         cols, scalars, pred_fn, value_fns, gidx_fn, G),
                     "library_ms": None})
    return out


def edge_checks(records, dev):
    """The kernels at the edges: 1 and 37 rows, no valid row, every row
    valid past the capacity, translate; predicates and values from the
    slice's own plans.  Returns the max error per kernel."""
    import torch

    kc, kf = kmod("compact"), kmod("filter_agg")

    errs = {}
    g = torch.Generator().manual_seed(0)
    preds = {e: a for _q, e, a, _k in records
             if e in ("compact_pred_query", "selective_agg_query")}
    for n in (1, 37, 5000):
        for p in (0.0, 0.3, 1.0):
            mask = (torch.rand(n, generator=g) < p).to(dev)
            for cap in (1, 8, 4096):
                for tr in (False, True):
                    e = max_err(kc.compact(mask, cap, translate=tr),
                                kc.compact_plain(mask, cap, tr),
                                f"compact edge n={n} cap={cap}")
                    errs["compact"] = max(errs.get("compact", 0.0), e)
            for G in (1, 7, 130):
                gidx = torch.randint(0, G, (n,), generator=g,
                                     dtype=torch.int32).to(dev)
                vals = [torch.randn(n, generator=g).to(dev)
                        for _ in range(3)]
                e = max_err(kf.filter_agg(mask, gidx, vals, G),
                            kf.filter_agg_plain(mask, gidx, vals, G),
                            f"filter_agg edge n={n} G={G}")
                errs["filter_agg"] = max(errs.get("filter_agg", 0.0), e)
        if "compact_pred_query" in preds:
            cols, scalars, pred_fn, _cap = to(dev, preds["compact_pred_query"])
            sub = {k: v[:n].contiguous() for k, v in cols.items()}
            for cap in (1, 8, 4096):
                for tr in (False, True):
                    e = max_err(
                        kc.compact_pred(sub, scalars, pred_fn, cap,
                                        translate=tr),
                        kc.compact_pred_plain(sub, scalars, pred_fn, cap, tr),
                        f"compact_pred edge n={n} cap={cap}")
                    errs["compact_pred"] = max(errs.get("compact_pred", 0.0),
                                               e)
        if "selective_agg_query" in preds:
            cols, scalars, pred_fn, vfns, gfn, G = to(
                dev, preds["selective_agg_query"])
            sub = {k: v[:n].contiguous() for k, v in cols.items()}
            e = max_err(
                kf.selective_filter_agg(sub, scalars, pred_fn, vfns, gfn, G),
                kf.selective_filter_agg_plain(sub, scalars, pred_fn, vfns,
                                              gfn, G),
                f"selective edge n={n}")
            errs["selective_filter_agg"] = max(
                errs.get("selective_filter_agg", 0.0), e)
    return errs


# a NaN in a row the mask drops (row 4), an infinity in a kept row of
# group 1 (row 2): the oracle keeps each out of every other group's sum
NF_MASK = [1, 0, 1, 1, 0, 1, 1, 1]
NF_GIDX = [0, 1, 1, 0, 0, 2, 2, 1]
NF_SUMS = [[6.0, 8.0], [float("inf"), 20.0], [22.0, 24.0]]


def nonfinite_cases(dev):
    """(label, G, columns, predicate, values, group index): the eight rows
    after `pad` NaN rows that the mask drops, for G = 3 (register regime)
    and G = 9 (shared-memory regime)."""
    import torch

    from repro_torch.core.expr import Cmp, Col, Const
    from repro_torch.core.operators.fused import GroupIndex, TileFn

    cases = []
    for pad in (0, 4093):
        vals = torch.arange(16, dtype=torch.float32).reshape(8, 2)
        vals[4, 1], vals[2, 0] = float("nan"), float("inf")
        vals = torch.cat([torch.full((pad, 2), float("nan")), vals])
        cols = {"m": torch.tensor([0] * pad + NF_MASK, dtype=torch.int32),
                "g": torch.tensor([0] * pad + NF_GIDX, dtype=torch.int32),
                "v0": vals[:, 0].contiguous(), "v1": vals[:, 1].contiguous()}
        cols = {k: v.to(dev) for k, v in cols.items()}
        for G in (3, 9):
            cases.append((f"pad {pad}, G={G}", G, cols,
                          TileFn(Cmp("==", Col("m"), Const(1)), []),
                          [TileFn(Col("v0"), []), TileFn(Col("v1"), [])],
                          GroupIndex([("g", G, 1)], G)))
    return cases


def nonfinite_checks(dev) -> None:
    """filter_agg and the generated selective kernel on the non-finite
    rows: sums bit for bit equal to the plain version on the same device
    and to the oracle's, counts exact."""
    import torch

    kf = kmod("filter_agg")
    want3 = torch.tensor(NF_SUMS, dtype=torch.float32)
    for label, G, cols, pred, vfns, gfn in nonfinite_cases(dev):
        mask = cols["m"] == 1
        vals = [cols["v0"], cols["v1"]]
        want = torch.zeros((G, 2), dtype=torch.float32)
        want[:3] = want3
        for what, got, plain in [
                ("filter_agg", kf.filter_agg(mask, cols["g"], vals, G),
                 kf.filter_agg_plain(mask, cols["g"], vals, G)),
                ("selective_filter_agg",
                 kf.selective_filter_agg(cols, [], pred, vfns, gfn, G),
                 kf.selective_filter_agg_plain(cols, [], pred, vfns, gfn,
                                               G))]:
            bits = got[0].view(torch.int32)
            check(torch.equal(bits, plain[0].view(torch.int32))
                  and torch.equal(bits.cpu(), want.view(torch.int32))
                  and torch.equal(got[1], plain[1]),
                  f"{what} non-finite {label}: sums differ")
    log("non-finite rows: filter_agg and the selective kernel equal the "
        "plain version and the oracle bit for bit (G = 3 and 9)")


def tile_predicate():
    """(predicate, its parameter names) of the many-tile compact_pred
    check: `x < t` over one float32 column, so t sets the density."""
    from repro_torch.core.expr import Cmp, Col, Param
    from repro_torch.core.operators.fused import TileFn

    return TileFn(Cmp("<", Col("x"), Param("t", "float32")), ["t"])


def many_tile_checks(dev) -> dict:
    """The look-back scan under many tiles: 2^22 + 37 rows (1,025 tiles of
    4,096; 2^16 + 37 in a CPU rehearsal) at densities 0, 0.5 and 1,
    capacity below and above the count, with and without translate, each
    call repeated 20 times against one plain answer, for the mask
    (`compact`) and for a predicate evaluated inside the scan
    (`compact_pred`, `x < t` over uniform x in [0, 1)).  Returns the max
    error per kernel (0: every repeat exact)."""
    import torch

    kc = kmod("compact")
    g = torch.Generator().manual_seed(1)
    n = (1 << 22) + 37 if dev.type == "cuda" else (1 << 16) + 37
    reps = 20 if dev.type == "cuda" else 1
    pred = tile_predicate()
    x = {"x": torch.rand(n, generator=g).to(dev)}
    errs = {"compact": 0.0, "compact_pred": 0.0}
    for p in (0.0, 0.5, 1.0):
        mask = (torch.rand(n, generator=g) < p).to(dev)
        cases = [("compact", mask, lambda cap, tr: kc.compact(
                      mask, cap, translate=tr),
                  lambda cap, tr: kc.compact_plain(mask, cap, tr)),
                 ("compact_pred", x["x"] < p, lambda cap, tr: kc.compact_pred(
                      x, [p], pred, cap, translate=tr),
                  lambda cap, tr: kc.compact_pred_plain(x, [p], pred, cap,
                                                        tr))]
        for name, m, kernel, plain in cases:
            count = int(m.sum())
            for cap in (max(count // 3, 1), count + 5):
                for tr in (False, True):
                    want = plain(cap, tr)
                    for r in range(reps):
                        errs[name] = max(errs[name], max_err(
                            kernel(cap, tr), want, f"{name} many tiles "
                            f"p={p} cap={cap} tr={tr} #{r}"))
    log(f"compaction and predicate compaction under "
        f"{-(-n // kc.TILE_ROWS)} tiles: every repeat equal to the plain "
        "version")
    return errs


def selective_repeat_checks(records, dev) -> float:
    """The selective kernel's fold, 20 calls back to back at 1, 37 and all
    of q6's rows (908,340 at SF 1), each against the plain version and
    bit-identical to the first: the last block of each launch sets the
    stream's ticket back to 0 for the next.  Returns the max error."""
    import torch

    kf = kmod("filter_agg")
    cols, sc, pred, vfns, gfn, G = next(
        to(dev, a) for q, e, a, _k in records
        if (q, e) == ("q6", "selective_agg_query"))
    n6 = next(iter(cols.values())).shape[0]
    err = 0.0
    for n in (1, 37, n6):
        sub = {k: v[:n].contiguous() for k, v in cols.items()}
        want = kf.selective_filter_agg_plain(sub, sc, pred, vfns, gfn, G)
        calls = [kf.selective_filter_agg(sub, sc, pred, vfns, gfn, G)
                 for _ in range(20)]
        for k, got in enumerate(calls):
            err = max(err, max_err(got, want, f"selective q6 {n} rows #{k}"))
            check(all(torch.equal(a, b) for a, b in zip(got, calls[0])),
                  f"selective q6 {n} rows: call {k} differs from call 0")
    log(f"selective kernel at 1, 37 and {n6} rows: 20 calls back to back, "
        "each equal to the plain version, all bit-identical")
    return err


def wide_agg_plan():
    """17 sums beside one group key: more value columns than one
    aggregation launch takes (16)."""
    from repro_torch.core import ir
    from repro_torch.core.expr import col

    return ir.Agg(ir.Scan("lineitem"), ["l_returnflag"],
                  [ir.AggSpec(f"s{k}", "sum", col("l_quantity"))
                   for k in range(17)])


def repair_checks(db, dev) -> float:
    """The shapes one aggregation launch cannot take, which the wrappers
    split by value columns: the 17-sum plan through the engine at
    opt-pallas against the port's CPU answer (G = 3, A = 17: two
    launches), and a dense G = 4096, A = 14 call (4096 x 15 x 4 B
    exceed one block's shared memory: two launches) against the plain
    version.  Returns the max error of the direct call."""
    import torch

    from repro_torch.core import CompiledQuery, preset

    kf = kmod("filter_agg")
    want = CompiledQuery(wide_agg_plan(), db, preset("opt-pallas"),
                         device="cpu").run()
    before = kf.launches["filter_agg"]
    got = CompiledQuery(wide_agg_plan(), db, preset("opt-pallas"),
                        device=None if dev.type == "cuda" else "cpu").run()
    assert_same(got, want, False, "17 sums by l_returnflag")
    if dev.type == "cuda":
        check(kf.launches["filter_agg"] == before + 2,
              "17 sums: not two launches")
    g = torch.Generator().manual_seed(4)
    n, G, A = 1 << 20, 4096, 14
    mask = (torch.rand(n, generator=g) < 0.7).to(dev)
    gidx = torch.randint(-1, G + 1, (n,), generator=g,
                         dtype=torch.int32).to(dev)
    vals = [torch.randn(n, generator=g).to(dev) for _ in range(A)]
    before = kf.launches["filter_agg"]
    err = max_err(kf.filter_agg(mask, gidx, vals, G),
                  kf.filter_agg_plain(mask, gidx, vals, G),
                  "filter_agg G=4096 A=14")
    if dev.type == "cuda":
        check(kf.launches["filter_agg"] == before + 2,
              "G=4096 A=14: not two launches")
    log("17 sums by l_returnflag (engine, opt-pallas) and G=4096 x A=14: "
        "equal to the CPU answer and the plain version, two launches each")
    return err


def one_kernel_a_call(name: str, fn, memsets: int) -> dict:
    """`profile_call(fn)` of a window in which every call was one kernel
    and `memsets` memsets, or fail.  A window that lost events shows
    fewer, never more, so a second and third window are taken before a
    shortfall fails."""
    for _ in range(3):
        p = profile_call(fn)
        check(p["kernels_per_call"] <= 1 and p["memsets_per_call"] <= memsets,
              f"{name}: {p['kernels_per_call']} kernels, "
              f"{p['memsets_per_call']} memsets a call")
        if p["kernels_per_call"] == 1 and p["memsets_per_call"] == memsets:
            log(f"{name}: one kernel and {memsets} memsets a call")
            return p
    check(False, f"{name}: {p['kernels_per_call']} kernels a call")


# ---------------------------------------------------------------------------
# phase 4b: the kernel library's surface
# ---------------------------------------------------------------------------

def subnormal_operands(db, dev):
    """(cols, predicate, values) of the subnormal edge check:
    `l_discount < 1.1754944e-39f` over lineitem, summing l_extendedprice.
    TPC-H discounts of 0.00 satisfy it; a flush to zero would drop them."""
    import torch

    from repro_torch.core.expr import Cmp, Col, Const
    from repro_torch.core.operators.fused import TileFn

    li = db.table("lineitem")
    cols = {c: torch.from_numpy(li.col(c)).to(dev)
            for c in ("l_discount", "l_extendedprice")}
    return (cols, TileFn(Cmp("<", Col("l_discount"), Const(SUBNORMAL)), []),
            [TileFn(Col("l_extendedprice"), [])])


# float32 bit patterns the order must place: +-0, +-NaN (with payloads,
# quiet and signalling), +-inf, +-subnormals, -3e38 and its neighbours
SPECIAL_BITS = [0x00000000, 0x80000000, 0x7fc00000, 0xffc00000, 0x7fc00001,
                0xffc00005, 0x7f800001, 0xff800001, 0x7f800000, 0xff800000,
                0x00000001, 0x80000001, 0x007fffff, 0x807fffff, 0xff61b1e6,
                0xff61b1e5, 0xff61b1e7]


def special_topk_cases(rng, dev_t):
    """(vals, mask, k, label): 40,000 rows (ten 4,096-row tiles), a third
    of them special values scattered among repeated ordinary ones, at
    k = 1, 10 and 1,024, with a random mask, every row masked, every
    value equal; and k > n."""
    import numpy as np

    n = 40_000
    vals = rng.choice(np.float32([-2.5, 0.5, 1.0, 3e38, -1.0]), n)
    at = rng.random(n) < 0.35
    vals[at] = rng.choice(np.array(SPECIAL_BITS, np.uint32),
                          int(at.sum())).view(np.float32)
    mask = rng.random(n) < 0.8
    cases = []
    for k in (1, 10, 1024):
        cases += [(dev_t(vals), dev_t(mask), k, f"scattered, k={k}"),
                  (dev_t(vals), dev_t(np.zeros(n, bool)), k,
                   f"all masked, k={k}"),
                  (dev_t(np.full(n, np.float32(0.5))), dev_t(mask), k,
                   f"all equal, k={k}")]
    cases.append((dev_t(vals[:700]), dev_t(mask[:700]), 1024,
                  "k > n (700 rows, k=1024)"))
    return cases


def same_bits(got, want, what: str) -> float:
    """Top-k outputs equal bit for bit (NaN payloads included)."""
    import torch

    check(torch.equal(got[1], want[1]), f"{what}: ids differ")
    check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
          f"{what}: value bits differ")
    return 0.0


def pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def library_phase(db, records, dev, subnormal, timed: bool):
    """Drive `repro_torch.kernels` once at SF 1 shapes between a reset and
    a read of the library kernels' launch counters, then hold every output
    and edge case against the plain versions and time each shape.
    Returns ({library kernel: entry}, {engine kernel: max error})."""
    import numpy as np
    import torch

    import repro_torch.kernels as lib
    from repro_torch.relational.schema import days

    kc, kf = kmod("compact"), kmod("filter_agg")
    kg, kt = kmod("gather_join"), kmod("topk")
    rng = np.random.default_rng(0)
    li = db.table("lineitem")

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def table(k, c):
        return dev_t(rng.normal(size=(k, c)).astype(np.float32))

    # -- inputs ------------------------------------------------------------
    gathers = {
        "c_nationkey into 25x3": (
            dev_t(db.table("customer").col("c_nationkey")), table(25, 3)),
        "l_suppkey into supplier x 3": (
            dev_t(li.col("l_suppkey")), table(db.table("supplier").nrows, 3)),
        "l_partkey into part x 2": (
            dev_t(li.col("l_partkey")), table(db.table("part").nrows, 2)),
    }
    price = dev_t(li.col("l_extendedprice"))
    q3_mask = dev_t(li.col("l_shipdate") > days("1995-03-15"))
    n_perm = 60_000
    topks = {f"l_extendedprice under q3's mask, k={k}": (price, q3_mask, k)
             for k in (1, 10, 100)}
    topks["distinct 60,000, k=10"] = (
        dev_t(rng.permutation(n_perm).astype(np.float32)),
        dev_t(rng.random(n_perm) < 0.5), 10)
    rec = {}
    for q, e, a, _k in records:     # the largest call of each (query, entry)
        a = to(dev, a)
        n = a[0].shape[0] if isinstance(a[0], torch.Tensor) \
            else next(iter(a[0].values())).shape[0]
        if (q, e) not in rec or n > rec[q, e][0]:
            rec[q, e] = (n, a)
    cols, scalars, pred, vfns, gfn, G = rec["q6", "selective_agg_query"][1]
    total = int(kf.selective_filter_agg_plain(cols, scalars, pred, vfns, gfn,
                                              G)[2])
    check(total > 1, f"q6 selects {total} rows")
    sels = {f"q6, capacity {cap}{', translate' if tr else ''}": (cap, tr)
            for cap in (pow2_at_least(total), total // 2)
            for tr in (False, True)}
    mask1, gidx1, vals1, G1 = rec["q1", "filter_agg_query"][1]
    gidx1, vals1 = gidx1.to(torch.int32), [v.to(torch.float32) for v in vals1]
    mask3, cap3 = rec["q3", "compact_query"][1]

    # -- the surface, once, between reset and read of the counters ---------
    counters = {"gather_join": kg.launches, "masked_topk": kt.launches,
                "selective_filter_agg_capacity": kf.launches}
    for name, d in counters.items():
        d[name] = 0
    got_g = {s: lib.gather_join(fk, t) for s, (fk, t) in gathers.items()}
    got_t = {s: lib.masked_topk(v, m, k) for s, (v, m, k) in topks.items()}
    got_s = {s: lib.selective_filter_agg(cols, scalars, pred, vfns, gfn,
                                         len(vfns), G, cap, tr)
             for s, (cap, tr) in sels.items()}
    got_fa = lib.filter_agg(mask1, gidx1, torch.stack(vals1, 1), G1)
    got_ct = lib.compact_translate(mask3, cap3)
    launched = {name: d[name] for name, d in counters.items()}
    log(f"library surface launches: {json.dumps(launched)}")

    # -- outputs against the plain versions --------------------------------
    errs = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    for s, (fk, t) in gathers.items():
        note("gather_join", max_err([got_g[s]], [kg.gather_join_plain(fk, t)],
                                    f"gather_join {s}", exact=True))
    for s, (v, m, k) in topks.items():
        note("masked_topk", max_err(got_t[s], kt.masked_topk_plain(v, m, k),
                                    f"masked_topk {s}", exact=True))
    base = kf.selective_filter_agg(cols, scalars, pred, vfns, gfn, G)
    for s, (cap, tr) in sels.items():
        want = kf.selective_filter_agg_plain(cols, scalars, pred, vfns, gfn,
                                             G, cap, tr)
        note("selective_filter_agg_capacity", max_err(
            got_s[s], (want[0], *want[2:]), f"selective {s}"))
        max_err(got_s[s][:1], base[:1], f"selective {s} vs capacity 0")
        log(f"selective {s}: count {int(got_s[s][1])}, sums bitwise equal "
            f"to the capacity-0 form: {torch.equal(got_s[s][0], base[0])}")
    note("filter_agg", max_err(
        [got_fa], [kf.filter_agg_plain(mask1, gidx1, vals1, G1)[0]],
        "filter_agg matrix q1"))
    note("compact", max_err(got_ct, kc.compact_plain(mask3, cap3, True),
                            "compact_translate q3"))

    # -- the subnormal literal ---------------------------------------------
    s_cols, s_pred, s_vals = subnormal
    s_true = int(s_pred(s_cols, []).sum())
    check(s_true > 0, "no row satisfies the subnormal predicate")
    cap = pow2_at_least(s_true)
    note("compact_pred", max_err(
        kc.compact_pred(s_cols, [], s_pred, cap, translate=True),
        kc.compact_pred_plain(s_cols, [], s_pred, cap, True),
        "compact_pred subnormal"))
    want = kf.selective_filter_agg_plain(s_cols, [], s_pred, s_vals, None, 1,
                                         cap, True)
    note("selective_filter_agg", max_err(
        kf.selective_filter_agg(s_cols, [], s_pred, s_vals, None, 1),
        want[:3], "selective subnormal"))
    note("selective_filter_agg_capacity", max_err(
        kf.selective_filter_agg(s_cols, [], s_pred, s_vals, None, 1,
                                capacity=cap, translate=True),
        want, "selective capacity subnormal"))
    log(f"subnormal literal: {s_true} rows kept by kernel and plain version")

    # -- edges -------------------------------------------------------------
    smem_rows = 227 * 1024 // 4        # one block's shared memory, C = 1
    for t in (gathers["c_nationkey into 25x3"][1],
              gathers["l_partkey into part x 2"][1],
              table(smem_rows, 1), table(smem_rows + 1, 1)):
        k = t.shape[0]
        for fk in ([-1], [k], rng.integers(0, k, 1),
                   rng.integers(-2, k + 2, 37), rng.integers(-2, k + 2, 5000)):
            fk = dev_t(np.asarray(fk, np.int32))
            note("gather_join", max_err(
                [lib.gather_join(fk, t)], [kg.gather_join_plain(fk, t)],
                f"gather_join edge K={k} n={fk.shape[0]}", exact=True))
    for c in (1, 2, 3, 5):
        k, n = 1000, 4 * 5000 + 3
        fk = dev_t(rng.integers(-2, k + 2, n + 1).astype(np.int32))[1:]
        t = rng.normal(size=(k, c)).astype(np.float32)
        t[1, 0], t[2, c - 1] = np.nan, np.inf
        t = dev_t(t)
        check(torch.equal(lib.gather_join(fk, t).view(torch.int32),
                          kg.gather_join_plain(fk, t).view(torch.int32)),
              f"gather_join C={c}, fk at an odd offset: differs")
    log("gather_join at C = 1, 2, 3, 5, fk a view at an odd offset, NaN "
        "and infinity in the table: bit for bit")
    ties = dev_t(np.full(3 * 4096 + 1, 7.0, np.float32))
    odd = dev_t(rng.choice(np.float32([-np.inf, 1.0, -3.0e38, 2.0]), 10_000))
    few = dev_t(rng.permutation(1000) < 5)
    for v, m, k, what in [
            (price[:1000], few, 100, "fewer valid rows than k"),
            (price[:5000], torch.zeros_like(q3_mask[:5000]), 10,
             "no valid row"),
            (price[:37], q3_mask[:37], 100, "k > n"),
            (price[:1], q3_mask[:1], 1, "n = 1"),
            (price, q3_mask, 1024, "q3, k = 1024"),
            (ties, torch.ones_like(ties, dtype=torch.bool), 1024,
             "equal values across blocks"),
            (odd, dev_t(rng.random(10_000) < 0.8), 1024,
             "-inf and -3e38 among the values")]:
        note("masked_topk", max_err(lib.masked_topk(v, m, k),
                                    kt.masked_topk_plain(v, m, k),
                                    f"masked_topk edge {what}", exact=True))
    for v, m, k, what in special_topk_cases(rng, dev_t):
        note("masked_topk", same_bits(lib.masked_topk(v, m, k),
                                      kt.masked_topk_plain(v, m, k),
                                      f"masked_topk special {what}"))
    log("masked_topk special values: ids and bit patterns equal to the "
        "plain version at k = 1, 10, 1024")
    for n in (1, 37, 5000):
        sub = {c: v[:n].contiguous() for c, v in cols.items()}
        for cap in (1, 8, 4096):
            for tr in (False, True):
                want = kf.selective_filter_agg_plain(sub, scalars, pred, vfns,
                                                     gfn, G, cap, tr)
                note("selective_filter_agg_capacity", max_err(
                    lib.selective_filter_agg(sub, scalars, pred, vfns, gfn,
                                             len(vfns), G, cap, tr),
                    (want[0], *want[2:]), f"selective edge n={n} cap={cap}"))

    # -- times ---------------------------------------------------------------
    def timing(label, n, nbytes_, kernel, plain, library):
        row = {"shape": label, "rows": n, "bytes": nbytes_,
               "bound_ms": nbytes_ / HBM_BYTES_PER_S * 1e3}
        row.update({k: (time_ms(f) if timed and f is not None else None)
                    for k, f in (("ms", kernel), ("plain_ms", plain),
                                 ("library_ms", library))})
        if timed:
            row.update(profile_call(kernel))
        return row

    timed_rows = {name: [] for name in LIBRARY_KERNELS}
    for s, (fk, t) in gathers.items():
        n, (k, c) = fk.shape[0], t.shape
        timed_rows["gather_join"].append(timing(
            s, n, 4 * n + 4 * k * c + 4 * n * c,
            lambda: lib.gather_join(fk, t),
            lambda: kg.gather_join_plain(fk, t),
            lambda: torch.index_select(t, 0, fk)))
    for s, (v, m, k) in topks.items():
        pre = torch.where(m, v, kt.NEG)
        timed_rows["masked_topk"].append(timing(
            s, v.shape[0], 5 * v.shape[0],
            lambda: lib.masked_topk(v, m, k),
            lambda: kt.masked_topk_plain(v, m, k),
            lambda: torch.topk(pre, k)))
    n6 = next(iter(cols.values())).shape[0]
    for s, (cap, tr) in sels.items():
        timed_rows["selective_filter_agg_capacity"].append(timing(
            s, n6, nbytes(*cols.values()) + 4 * cap + (4 * n6 if tr else 0),
            lambda: lib.selective_filter_agg(cols, scalars, pred, vfns, gfn,
                                             len(vfns), G, cap, tr),
            lambda: kf.selective_filter_agg_plain(cols, scalars, pred, vfns,
                                                  gfn, G, cap, tr),
            None))
    main_shape = {"gather_join": 1, "masked_topk": 1,
                  "selective_filter_agg_capacity": 0}
    out = {}
    for name in LIBRARY_KERNELS:
        for r in timed_rows[name]:
            log(f"{name} {r['shape']}: {json.dumps(r)}")
        main = timed_rows[name][main_shape[name]]
        out[name] = {"max_abs_err": errs[name], "launches": launched[name],
                     "n": main["rows"], "bytes": main["bytes"],
                     "ms": main["ms"], "plain_ms": main["plain_ms"],
                     "library_ms": main["library_ms"],
                     "shape": main["shape"], "timed": timed_rows[name]}
        out[name].update({k: main[k] for k in PROFILED if k in main})
    return out, {k: v for k, v in errs.items() if k in ENGINE_KERNELS}


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_path(db, queries, answers, counters, args):
    """Every query through `CompiledQuery(...).run()` on the card: at opt
    and opt-pallas against its CPU answer at the same preset, at the lower
    rungs against the CPU answer at opt, and the row layout of
    ROW_QUERIES at ROW_RUNGS likewise.  Checks each run's launches (none
    outside opt-pallas; at opt-pallas exactly LAUNCHES_SF1's) and times
    it: median and minimum of RUNS runs after one warm-up, each `run()`
    (the answer
    decoded on the host) and the device program alone (`execute` and a
    synchronisation).  Each query is freed before the next is built.
    Returns the launches of the whole phase, the card's answers at
    PRESETS (column layout) and their median `run()` ms by (query,
    preset)."""
    import dataclasses

    import torch
    from repro_torch.core import CompiledQuery, preset

    cuda = not args.rehearse
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    configs = [(q, p, "column") for p in PRESETS + LOWER_RUNGS
               for q in queries] \
        + [(q, p, "row") for p in ROW_RUNGS for q in ROW_QUERIES]
    per_rung: dict = {}
    card: dict = {}
    medians: dict = {}
    for q, p, layout in configs:
        t_cfg = time.perf_counter()
        before = {name: d[k] for name, (d, k) in counters.items()}
        cq = CompiledQuery(queries[q](), db,
                           dataclasses.replace(preset(p), layout=layout),
                           device="cpu" if args.rehearse else None)
        got = cq.run()
        want = answers[q, p if p in PRESETS else "opt"]
        what = f"{q} {p}" + (" row" if layout == "row" else "")
        assert_same(got, want, q in SORT_INSENSITIVE, what)
        if p in PRESETS and layout == "column":
            card[q, p] = got
        delta = {name: d[k] - before[name]
                 for name, (d, k) in counters.items() if d[k] > before[name]}
        if cuda and p != "opt-pallas":
            check(not delta, f"{what}: a kernel launched ({delta})")
        if cuda and p == "opt-pallas":
            check(delta == LAUNCHES_SF1[q],
                  f"{what}: launches {delta}, the reference's "
                  f"{LAUNCHES_SF1[q]}")

        def timed(fn):
            fn()
            out = []
            for _ in range(RUNS):
                sync()
                t = time.perf_counter()
                fn()
                sync()
                out.append((time.perf_counter() - t) * 1e3)
            return out

        if cuda:            # a rehearsal checks answers only
            run_ms = timed(cq.run)
            medians[q, p, layout] = statistics.median(run_ms)
            inputs = cq.bind()
            exec_ms = timed(lambda: cq.execute(inputs))
            del inputs
            log(f"query {what}: median {statistics.median(run_ms):.3f} ms "
                f"(min {min(run_ms):.3f}) over {len(run_ms)} runs, device "
                f"program median {statistics.median(exec_ms):.3f} ms "
                f"(min {min(exec_ms):.3f}), overflows {cq.n_overflows}, "
                f"launches {json.dumps(delta)}, inputs "
                f"{cq.input_nbytes()} B, {time.perf_counter() - t_cfg:.1f} s")
        check(cq.n_overflows == 0 or p not in PRESETS,
              f"{what}: {cq.n_overflows} overflows")
        key = p + (" row" if layout == "row" else "")
        per_rung[key] = per_rung.get(key, 0.0) + time.perf_counter() - t_cfg
        del cq
    log("phase 5 seconds by rung: " + json.dumps(
        {k: round(v, 1) for k, v in per_rung.items()}))
    return ({name: d[k] for name, (d, k) in counters.items()}, card,
            {(q, p): ms for (q, p, layout), ms in medians.items()
             if layout == "column"})


# ---------------------------------------------------------------------------
# phase 7: the serving path
# ---------------------------------------------------------------------------

def param_bindings(pq, alt, q) -> dict:
    """A parameterized query's two bindings: its defaults (the literal
    query's values) and the alternative overlay."""
    return {"default": dict(pq[q][1]), "alt": dict(pq[q][1], **alt[q])}


def param_answers(db):
    """Every parameterized query under both bindings through a CPU plan
    cache at opt: the serving phase's reference answers."""
    from repro_torch.core import PlanCache, preset
    from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                                PARAM_QUERIES)

    cache = PlanCache(db, device="cpu")
    out = {}
    for q in sorted(PARAM_QUERIES):
        for name, b in param_bindings(PARAM_QUERIES, PARAM_ALT_BINDINGS,
                                      q).items():
            out[q, name] = cache.execute(PARAM_QUERIES[q][0](),
                                         preset("opt"), b)
    cache.close()
    return out


def overflow_plan():
    """count and sum over `l_quantity < 26` (about half of lineitem)
    squeezed through a hand-planted 64-row compaction point."""
    from repro_torch.core.expr import Cmp, col, lit
    from repro_torch.core.ir import Agg, AggSpec, Compact, Scan, Select

    sel = Select(Scan("lineitem"), Cmp("<", col("l_quantity"), lit(26.0)))
    return Agg(Compact(sel, 64), [],
               [AggSpec("s", "sum", col("l_extendedprice")),
                AggSpec("c", "count")])


def serving_path(db, answers, counters, args) -> None:
    """The runtime and serving layer on the card at opt-pallas: (a) a plan
    cache over the six parameterized queries, default then alternative
    bindings, (b) execute_many, (c) a forced overflow and its feedback
    re-plan, (d) the tiered cache, (e) the query server, (f) the chaos
    harness, (g) warm state saved and loaded, (h) device memory.  Logs
    a line of numbers a step."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.core import CompiledQuery, PlanCache, preset
    from repro_torch.core import compile as compile_mod
    from repro_torch.core.passes.compaction import observed_bucket
    from repro_torch.kernels import build
    from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                                PARAM_QUERIES)
    from repro_torch.serve.chaos import run_chaos
    from repro_torch.serve.query_server import QueryServer

    cuda = not args.rehearse
    device = "cpu" if args.rehearse else None
    S = preset("opt-pallas")
    shapes = sorted(PARAM_QUERIES)
    binds = {q: param_bindings(PARAM_QUERIES, PARAM_ALT_BINDINGS, q)
             for q in shapes}
    plan = {q: PARAM_QUERIES[q][0] for q in shapes}
    if cuda:
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    report: dict = {}

    def launched(before):
        return {n: d[k] - before[n] for n, (d, k) in counters.items()
                if d[k] > before[n]}

    def snapshot():
        return {n: d[k] for n, (d, k) in counters.items()}

    def ms_since(t):
        return (time.perf_counter() - t) * 1e3

    # -- (a) the plan cache: one staging per shape, no build on rebind ----
    cache = PlanCache(db, device=device)
    for q in shapes:
        s0, libs0 = compile_mod.STAGINGS, len(build._LIBS)
        t = time.perf_counter()
        cq, _rt = cache.get(plan[q](), S, binds[q]["default"])
        stage_ms = ms_since(t)
        t = time.perf_counter()
        cq.compile()
        compile_ms = ms_since(t)
        libs_built = len(build._LIBS) - libs0
        before = snapshot()
        t = time.perf_counter()
        got = cache.execute(plan[q](), S, binds[q]["default"])
        first_ms = ms_since(t)
        delta = {"default": launched(before)}
        assert_same(got, answers[q, "default"], q in SORT_INSENSITIVE,
                    f"serve {q} default")
        libs1 = len(build._LIBS)
        before = snapshot()
        t = time.perf_counter()
        got = cache.execute(plan[q](), S, binds[q]["alt"])
        alt_ms = ms_since(t)
        delta["alt"] = launched(before)
        assert_same(got, answers[q, "alt"], q in SORT_INSENSITIVE,
                    f"serve {q} alt")
        check(compile_mod.STAGINGS - s0 == 1,
              f"{q}: {compile_mod.STAGINGS - s0} stagings for two bindings")
        check(len(build._LIBS) == libs1, f"{q}: the rebind built a library")
        check(cq.n_overflows == 0, f"{q}: {cq.n_overflows} overflows")
        if cuda:
            for name, d in delta.items():
                check(d == LAUNCHES_SF1_PARAM[q],
                      f"serve {q} {name}: launches {d}, the reference's "
                      f"{LAUNCHES_SF1_PARAM[q]}")
        del cq
        cache.execute(plan[q](), S, binds[q]["default"])
        warm = []
        for _ in range(RUNS):
            t = time.perf_counter()
            cache.execute(plan[q](), S, binds[q]["default"])
            warm.append(ms_since(t))
        report[q] = {"stage_ms": stage_ms, "compile_ms": compile_ms,
                     "libraries_built": libs_built, "first_run_ms": first_ms,
                     "cold_ms": stage_ms + compile_ms + first_ms,
                     "alt_ms": alt_ms,
                     "warm_median_ms": statistics.median(warm),
                     "warm_min_ms": min(warm), "launches": delta}
        log(f"serve {q}: " + json.dumps(report[q]))
    # a specialized binding is new source: it pays nvcc again
    libs0 = len(build._LIBS)
    t = time.perf_counter()
    got = cache.execute(plan["q6"](), S, binds["q6"]["alt"],
                        mode="specialize")
    report["q6 specialize"] = {"cold_ms": ms_since(t),
                               "libraries_built": len(build._LIBS) - libs0}
    assert_same(got, answers["q6", "alt"], False, "serve q6 specialize")
    if cuda:
        check(report["q6 specialize"]["libraries_built"] == 1,
              "a specialized binding of q6 built no library")
    log("serve q6 specialize: " + json.dumps(report["q6 specialize"]))
    log(f"plan cache: {cache.stats}")

    # -- (b) execute_many and run_many against run --------------------------
    # three ways to answer n bindings, each timed as the least of 3 passes:
    # the cache's execute_many (keying every binding, then one run_many),
    # the entry's own run_many (n staged walks, one read of the counts)
    # and n run calls (a read of the counts each)
    def least_ms(fn, reps=3):
        best = None
        for _ in range(reps):
            t = time.perf_counter()
            got = fn()
            ms = ms_since(t)
            best = ms if best is None else min(best, ms)
        return best, got

    for q in ("q6", "q12"):
        cq, _rt = cache.get(plan[q](), S, binds[q]["default"])
        rts = [{k: b[k] for k in cq.param_spec}
               for b in (binds[q]["default"], binds[q]["alt"])]
        for n in (1, 4, 16):
            bl = [(binds[q]["default"], binds[q]["alt"])[i % 2]
                  for i in range(n)]
            rl = [rts[i % 2] for i in range(n)]
            many_ms, many = least_ms(
                lambda: cache.execute_many(plan[q](), S, bl))
            rmany_ms, rmany = least_ms(lambda: cq.run_many(rl))
            runs_ms, singles = least_ms(lambda: [cq.run(r) for r in rl])
            for i, (g, r, w) in enumerate(zip(many, rmany, singles)):
                assert_same(g, w, False, f"execute_many {q} {n}[{i}]")
                assert_same(r, w, False, f"run_many {q} {n}[{i}]")
                assert_same(g, answers[q, ("default", "alt")[i % 2]],
                            q in SORT_INSENSITIVE,
                            f"execute_many {q} {n}[{i}] against the CPU")
            report[f"{q} execute_many {n}"] = {
                "ms_per_binding": many_ms / n,
                "run_many_ms_per_binding": rmany_ms / n,
                "run_ms_per_binding": runs_ms / n}
            log(f"execute_many {q} x{n}: {many_ms / n:.3f} ms a binding, "
                f"run_many {rmany_ms / n:.3f}, {n} runs "
                f"{runs_ms / n:.3f} ms a binding (least of 3)")
        del cq

    # -- (c) a forced overflow and the feedback re-plan ---------------------
    s_over = dataclasses.replace(S, compact_replan_after=1)
    want = CompiledQuery(overflow_plan(), db, preset("opt"),
                         device="cpu").run()
    ocache = PlanCache(db, device=device)
    cq0, _ = ocache.get(overflow_plan(), s_over)
    got = ocache.execute(overflow_plan(), s_over)
    assert_same(got, want, False, "overflow: the twin's answer")
    true = int(want["c"][0])
    check(cq0.n_overflows == 1 and true > 64, "overflow: no overflow")
    check(cq0.observed_max.get("h0") == true,
          f"overflow: observed {cq0.observed_max}, true count {true}")
    check(ocache.stats.replans == 1, f"overflow: {ocache.stats}")
    del cq0
    s0 = compile_mod.STAGINGS
    got = ocache.execute(overflow_plan(), s_over)
    cq1, _ = ocache.get(overflow_plan(), s_over)
    check(compile_mod.STAGINGS - s0 == 1, "overflow: the re-plan staged "
          f"{compile_mod.STAGINGS - s0} times")
    check(cq1.n_overflows == 0 and cq1.point_caps["h0"]
          == observed_bucket(true), f"overflow: after the re-plan "
          f"{cq1.point_caps}, {cq1.n_overflows} overflows")
    assert_same(got, want, False, "overflow: the re-planned answer")
    report["overflow"] = {"true_count": true, "capacity": cq1.point_caps}
    log(f"forced overflow: {json.dumps(report['overflow'])}, {ocache.stats}")
    del cq1
    ocache.close()

    # -- (d) the tiered cache: oracle first, then the card ------------------
    tcache = PlanCache(db, tiered=True, device=device)
    for q in ("q6", "q12"):
        b = binds[q]["default"]
        t = time.perf_counter()
        res1, tier1 = tcache.execute_tiered(plan[q](), S, b)
        oracle_ms = ms_since(t)
        check(tier1 == "oracle", f"tiered {q}: request 1 served by {tier1}")
        t = time.perf_counter()
        check(tcache.await_promotion(plan[q](), S, b, timeout=600),
              f"tiered {q}: promotion failed")
        wait_ms = ms_since(t)
        t = time.perf_counter()
        res2, tier2 = tcache.execute_tiered(plan[q](), S, b)
        promoted_ms = ms_since(t)
        check(tier2 == "opt-pallas", f"tiered {q}: then served by {tier2}")
        assert_same(res1, res2, False, f"tiered {q}: oracle vs opt-pallas")
        assert_same(res2, answers[q, "default"], False, f"tiered {q}")
        report[f"{q} tiered"] = {"oracle_ms": oracle_ms,
                                 "promotion_wait_ms": wait_ms,
                                 "promoted_ms": promoted_ms}
        log(f"tiered {q}: " + json.dumps(report[f"{q} tiered"]))
    tcache.close()

    # -- (e) the query server -----------------------------------------------
    reqs = [(q, name) for _ in range(4) for q in shapes
            for name in ("default", "alt")]
    s0 = compile_mod.STAGINGS
    srv = QueryServer(db, S, window_s=3600.0, device=device)
    t = time.perf_counter()
    results = srv.serve_batch([(plan[q](), binds[q][name])
                               for q, name in reqs])
    serve_ms = ms_since(t)
    srv.close()
    st = srv.stats
    for (q, name), got in zip(reqs, results):
        assert_same(got, answers[q, name], q in SORT_INSENSITIVE,
                    f"server {q} {name}")
    check(st.completed == len(reqs) and st.errors == 0
          and st.outstanding() == 0, f"server: {st}")
    check(compile_mod.STAGINGS - s0 == len(shapes),
          f"server: {compile_mod.STAGINGS - s0} stagings for "
          f"{len(shapes)} shapes")
    report["server"] = {"requests": len(reqs), "ms": serve_ms,
                        "batches": st.batches, "coalesced": st.coalesced,
                        "p50_ms": st.latency.p50() * 1e3,
                        "p99_ms": st.latency.p99() * 1e3}
    log("server: " + json.dumps(report["server"]))
    del srv, results

    # -- (f) chaos -------------------------------------------------------------
    t = time.perf_counter()
    rep = run_chaos(db, S, seed=0, n_requests=48, device=device)
    for k in ("all_resolved", "balanced", "retried_ok"):
        check(rep[k], f"chaos: not {k}: {rep}")
    check(rep["oracle_drift"] == 0, f"chaos: drift {rep['oracle_drift']}")
    report["chaos"] = {"injected": rep["injected"],
                       "outcomes": rep["outcomes"], "ms": ms_since(t)}
    log("chaos: " + json.dumps(report["chaos"]))

    # -- (g) warm state ------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="warm-state-")
    try:
        path = f"{tmp}/warm.json"
        n = cache.save(path)
        fresh = PlanCache(db, device=device)
        check(n == len(shapes) + 1 and fresh.load(path) == n,
              f"warm state: {n} records saved")
        check(all(fresh.is_warm(plan[q](), S, binds[q]["default"])
                  for q in shapes), "warm state: a shape is not warm")
        for base, fb in cache._feedback.items():
            got = fresh._feedback[base]
            check((got.observed, got.overrides) == (fb.observed,
                                                    fb.overrides),
                  "warm state: a record changed on the way")
        fresh.close()
    finally:
        shutil.rmtree(tmp)
    cache.close()

    # -- (h) device memory ---------------------------------------------------
    if cuda:
        import gc

        gc.collect()
        torch.cuda.synchronize()
        report["memory"] = {
            "before_bytes": mem_before,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "after_close_bytes": torch.cuda.memory_allocated()}
        log("serving memory: " + json.dumps(report["memory"]))
        check(report["memory"]["after_close_bytes"]
              <= mem_before + (64 << 20),
              "closing the caches and servers left device memory held")


# ---------------------------------------------------------------------------
# phase 8: the sharded path
# ---------------------------------------------------------------------------

# (preset, shards) of the sharded runs
SHARDED_CONFIGS = [("opt", 2), ("opt-pallas", 2), ("opt-pallas", 4)]
SHARDED_RUNS = 3                 # timed runs of each sharded query
# each kernel module's launch counter against its engine entry point's
# count in `ops.calls`
CALL_OF = {"compact": "compact", "compact_pred": "compact_pred",
           "filter_agg": "filter_agg",
           "selective_filter_agg": "selective_agg"}


def place_shards(n: int, cuda: bool) -> str:
    """Make n mesh slots visible: n CUDA devices when the machine has
    them, else n virtual slots on cuda:0 (on the CPU in a rehearsal).
    Returns which."""
    import torch
    from repro_torch.core import mesh

    if not cuda:
        mesh.virtual_devices("cpu", n)
        return f"{n} virtual slots on the cpu"
    have = torch.cuda.device_count()
    if have >= n:
        mesh.virtual_devices("cuda:0", 1)
        return f"the first {n} of {have} CUDA devices"
    mesh.virtual_devices("cuda:0", n)
    return f"{n} virtual slots on cuda:0 ({have} CUDA device(s) visible)"


def cpu_exchanges(db, queries) -> dict:
    """The Exchange count of every query's plan at SHARDED_CONFIGS: the
    port's `optimize()` planning for the CPU over as many virtual
    slots."""
    import dataclasses

    from repro_torch.core import ir, mesh, optimize, preset

    out = {}
    try:
        for p, n in SHARDED_CONFIGS:
            mesh.virtual_devices("cpu", n)
            for q in queries:
                plan = optimize(queries[q](), db, dataclasses.replace(
                    preset(p), shards=n), device="cpu")
                out[q, p, n] = sum(isinstance(x, ir.Exchange)
                                   for x in ir.walk(plan))
    finally:
        mesh.virtual_devices("cpu", 1)
    return out


def shards_identical(shards, what: str) -> None:
    """Every shard's columns, mask and counts bit for bit shard 0's."""
    import torch

    out0, mask0, counts0 = shards[0]
    for rank, (out, mask, counts) in enumerate(shards[1:], 1):
        check(set(out) == set(out0), f"{what}: shard {rank}'s columns")
        for k, v in out0.items():
            check(torch.equal(out[k].to(v.device), v),
                  f"{what}: shard {rank} differs in {k}")
        check(torch.equal(mask.to(mask0.device), mask0),
              f"{what}: shard {rank}'s mask differs")
        for pid, c in counts0.items():
            check(pid in counts, f"{what}: shard {rank} lacks point {pid}")


def entry_rows(a) -> int:
    """The rows of an entry point's call (its first argument's)."""
    first = a[0]
    return (first if not isinstance(first, dict)
            else next(iter(first.values()))).shape[0]


def sharded_path(db, queries, card, unsharded_ms, counters, args):
    """Every query at SHARDED_CONFIGS through `CompiledQuery(...).run()`
    on a data mesh of the card: n_shards as asked, the Exchange count of
    the CPU's plan, two runs each equal to phase 5's unsharded card
    answer, every shard's output bit for bit the same, no overflow, at
    opt-pallas every engine call a launch of its kernel (none at opt),
    and the median of SHARDED_RUNS `run()`s beside phase 5's unsharded
    median.  At opt-pallas the first run of each query records, from
    every shard's thread, the largest call of each entry point with a
    copy of its card tensors; after the query's launches are read each
    is held against its plain version (`kernel_checks`, untimed).
    Returns the launches of the phase's opt-pallas runs and the checks
    per kernel (max error, the largest per-shard rows)."""
    import dataclasses
    import threading

    import torch

    import repro_torch.kernels.ops as kops
    from repro_torch.core import CompiledQuery, ir, mesh, preset

    cuda = not args.rehearse
    dev = torch.device("cuda" if cuda else "cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    exchanges = cpu_exchanges(db, queries)
    launched = {name: 0 for name in counters}
    called = {name: 0 for name in counters}
    checks: dict = {}
    largest: dict = {}          # entry -> (rows, args, kwargs)
    recording = [False]
    lock = threading.Lock()
    saved = {e: getattr(kops, e) for e in ENTRY_POINTS}

    def recorder(entry, fn):
        def g(*a, **k):
            if recording[0]:
                rows = entry_rows(a)
                with lock:
                    if rows > largest.get(entry, (-1,))[0]:
                        largest[entry] = (rows, to(dev, a, copy=True),
                                          to(dev, k, copy=True))
            return fn(*a, **k)
        return g

    for e in ENTRY_POINTS:
        setattr(kops, e, recorder(e, saved[e]))
    try:
        for p, n in SHARDED_CONFIGS:
            log(f"phase 8 {p} x{n}: " + place_shards(n, cuda))
            for q in queries:
                t_cfg = time.perf_counter()
                what = f"{q} {p} x{n}"
                before = {name: d[k] for name, (d, k) in counters.items()}
                calls0 = dict(kops.calls)
                cq = CompiledQuery(queries[q](), db, dataclasses.replace(
                    preset(p), shards=n),
                    device="cpu" if args.rehearse else None)
                check(cq.n_shards == n, f"{what}: {cq.n_shards} shards")
                n_ex = sum(isinstance(x, ir.Exchange)
                           for x in ir.walk(cq.plan))
                check(n_ex == exchanges[q, p, n],
                      f"{what}: {n_ex} exchanges, the CPU plan's "
                      f"{exchanges[q, p, n]}")
                for i in range(2):  # the second merges the shard counts
                    recording[0] = i == 0 and p == "opt-pallas"
                    assert_same(cq.run(), card[q, p], q in SORT_INSENSITIVE,
                                what)
                    recording[0] = False
                shards_identical(cq.execute_shards(cq.bind()), what)
                check(cq.n_overflows == 0,
                      f"{what}: {cq.n_overflows} overflows")
                ms = []
                for _ in range(SHARDED_RUNS):
                    sync()
                    t = time.perf_counter()
                    cq.run()
                    sync()
                    ms.append((time.perf_counter() - t) * 1e3)
                delta = {name: d[k] - before[name]
                         for name, (d, k) in counters.items()}
                calls = {name: kops.calls[e] - calls0[e]
                         for name, e in CALL_OF.items()}
                if cuda and p == "opt-pallas":
                    check(delta == calls, f"{what}: launches {delta} for "
                          f"the engine's calls {calls}")
                elif cuda:
                    check(not any(delta.values()),
                          f"{what}: a kernel launched ({delta})")
                if p == "opt-pallas":
                    for name, v in delta.items():
                        launched[name] += v
                        called[name] += calls[name]
                    # after the launches are read: these calls launch too
                    got = kernel_checks(
                        [(what, e, a, k) for e, (_r, a, k) in largest.items()],
                        dev, timed=False)
                    largest.clear()
                    for name, c in got.items():
                        e = checks.setdefault(name, {"max_abs_err": 0.0,
                                                     "rows": 0})
                        e["max_abs_err"] = max(e["max_abs_err"],
                                               c["max_abs_err"])
                        e["rows"] = max(e["rows"], c["n"])
                obs = {pid: v.tolist() for pid, v in cq.observed_shard.items()}
                flat = unsharded_ms.get((q, p))
                log(f"sharded {what}: median {statistics.median(ms):.3f} ms "
                    f"(min {min(ms):.3f}) over {len(ms)} runs, unsharded "
                    + (f"{flat:.3f} ms" if flat is not None else "not timed")
                    + f" (phase 5), exchanges {n_ex}, per-shard counts "
                    f"{json.dumps(obs)}, launches "
                    f"{json.dumps({k: v for k, v in delta.items() if v})}, "
                    f"{time.perf_counter() - t_cfg:.1f} s")
                del cq
    finally:
        for e in ENTRY_POINTS:
            setattr(kops, e, saved[e])
        mesh.virtual_devices("cpu" if args.rehearse else "cuda:0", 1)
    unchecked = [k for k, v in called.items() if v and k not in checks]
    check(not unchecked, f"phase 8: no per-shard check of {unchecked}")
    for name, c in checks.items():
        log(f"phase 8 {name}: per-shard calls up to {c['rows']} rows, max "
            f"err {c['max_abs_err']} against the plain version")
    return launched, checks


# ---------------------------------------------------------------------------
# phase 9: the port's plan fuzzer on the card
# ---------------------------------------------------------------------------

FUZZ_SF = 0.05
FUZZ_PLANS = 24                  # naive and opt compiled for each
FUZZ_KERNEL_PLANS = 4            # opt-pallas compiled: an nvcc a predicate
FUZZ_SHARDS = 4                  # virtual slots the opt-shard rung plans over


def fuzz_phase(args) -> None:
    """`run_fuzz` on the card: FUZZ_PLANS seeded plans through every
    `optimize()` rung (the ladder, opt-pallas and opt-shard over
    FUZZ_SHARDS slots) with `naive` and `opt` compiled against the port's
    Volcano, and the first FUZZ_KERNEL_PLANS of them compiled at
    opt-pallas.  Any failure fails the run."""
    from repro_torch.core import mesh
    from repro_torch.core.analysis.fuzz import run_fuzz
    from repro_torch.relational import Database

    cuda = not args.rehearse
    device = "cuda" if cuda else "cpu"
    t0 = time.perf_counter()
    db = Database.tpch(sf=FUZZ_SF, seed=0)
    try:
        log("phase 9 opt-shard: " + place_shards(FUZZ_SHARDS, cuda))
        rep = run_fuzz(db, FUZZ_PLANS, compile_presets=["naive", "opt"],
                       device=device)
        t1 = time.perf_counter()
        kern = run_fuzz(db, FUZZ_KERNEL_PLANS, presets=[],
                        compile_presets=["opt-pallas"], device=device)
    finally:
        mesh.virtual_devices("cuda:0" if cuda else "cpu", 1)
    failures = rep.failures + kern.failures
    log(f"fuzz sf={FUZZ_SF}: {rep.n_plans} plans, {rep.n_optimized} "
        f"optimizes, {rep.n_compiled + kern.n_compiled} compiles "
        f"({kern.n_compiled} at opt-pallas), {len(failures)} failures; "
        f"naive/opt {t1 - t0:.1f} s, opt-pallas "
        f"{time.perf_counter() - t1:.1f} s")
    for f in failures[:5]:
        log(f"  fuzz failure: seed={f['seed']} preset={f['preset']} "
            f"[{f['stage']}] {f['error']}")
    check(not failures, f"the fuzzer found {len(failures)} failures")
    check(kern.n_compiled == FUZZ_KERNEL_PLANS,
          f"{kern.n_compiled} opt-pallas compiles")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU; prints no result")
    args = ap.parse_args()

    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not args.rehearse and (args.sf, args.seed) != (1.0, 0):
        print("chip_smoke: the card runs TPC-H SF 1, seed 0 (LAUNCHES_SF1)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.relational import Database

    kc, kf = kmod("compact"), kmod("filter_agg")
    from repro_torch.relational.queries import QUERIES

    dev = torch.device("cpu" if args.rehearse else "cuda")
    t_start = time.perf_counter()
    if not args.rehearse:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

    # -- phase 2 ------------------------------------------------------------
    t0 = time.perf_counter()
    db = Database.tpch(sf=args.sf, seed=args.seed)
    log(f"tpch sf={args.sf} seed={args.seed}: lineitem "
        f"{db.table('lineitem').nrows} rows, {time.perf_counter() - t0:.1f} s")
    answers, all_records = cpu_answers(db, QUERIES)
    served = param_answers(db)
    records = [r for r in all_records if r[0] in SLICE]
    seen = {(q, e) for q, e, _a, _k in records}
    for q, e in [("q1", "filter_agg_query"), ("q3", "compact_query"),
                 ("q6", "selective_agg_query"), ("q12", "compact_pred_query"),
                 ("q12", "filter_agg_query")]:
        check((q, e) in seen, f"{q} did not reach {e}")
    subnormal = subnormal_operands(db, dev)
    log(f"phase 2 (data and CPU answers): {time.perf_counter() - t0:.1f} s")

    # -- phase 3 ------------------------------------------------------------
    if not args.rehearse:
        t0 = time.perf_counter()
        sources = build.static_sources()
        # every generated kernel phase 5 reaches, the row layout's strided
        # instances too: sources from the CPU operands (a column's dtype
        # and stride are all the source depends on)
        for _q, e, a, _k in all_records:
            if e == "compact_pred_query":
                sources.append(kc.pred_source(a[0], a[1], a[2]))
            elif e == "selective_agg_query":
                sources.append(kf.selective_source(*a))
        s_cols, s_pred, s_vals = subnormal
        sources += [kc.pred_source(s_cols, [], s_pred),
                    kf.selective_source(s_cols, [], s_pred, s_vals, None, 1)]
        sources += [kf.selective_source(cols, [], pred, vfns, gfn, G)
                    for _l, G, cols, pred, vfns, gfn in nonfinite_cases(dev)]
        sources.append(kc.pred_source({"x": torch.zeros(1, device=dev)},
                                      [0.5], tile_predicate()))
        for p in build.build_all(sources):
            ptx = [ln for ln in p.with_suffix(".log").read_text().splitlines()
                   if "registers" in ln or "spill" in ln]
            log(f"built {p.name}: " + " | ".join(s.strip() for s in ptx))
        log(f"build: {len(sources)} libraries, "
            f"{time.perf_counter() - t0:.1f} s")

    # -- phase 4 ------------------------------------------------------------
    t0 = time.perf_counter()
    checks = kernel_checks(records, dev, timed=not args.rehearse)
    for name, err in edge_checks(records, dev).items():
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
    for name, err in many_tile_checks(dev).items():
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
    checks["selective_filter_agg"]["max_abs_err"] = max(
        checks["selective_filter_agg"]["max_abs_err"],
        selective_repeat_checks(records, dev))
    checks["filter_agg"]["max_abs_err"] = max(
        checks["filter_agg"]["max_abs_err"], repair_checks(db, dev))
    nonfinite_checks(dev)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # -- phase 4b -----------------------------------------------------------
    t0 = time.perf_counter()
    library, errs = library_phase(db, records, dev, subnormal,
                                  timed=not args.rehearse)
    for name, err in errs.items():
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
    if not args.rehearse:
        idle = [k for k, v in library.items() if v["launches"] == 0]
        check(not idle, f"never launched on the library surface: {idle}")
    log(f"library surface: {time.perf_counter() - t0:.1f} s")

    # -- phase 5 ------------------------------------------------------------
    t0 = time.perf_counter()
    counters = {"compact": (kc.launches, "compact"),
                "compact_pred": (kc.launches, "compact_pred"),
                "filter_agg": (kf.launches, "filter_agg"),
                "selective_filter_agg": (kf.launches, "selective_filter_agg")}
    for d, k in counters.values():
        d[k] = 0
    launched, card, unsharded_ms = main_path(db, QUERIES, answers, counters,
                                             args)
    log(f"main path launches: {json.dumps(launched)}")
    if not args.rehearse:
        missing = [k for k, v in launched.items() if v == 0]
        check(not missing, f"never launched on the main path: {missing}")
    log(f"phase 5 (main path): {time.perf_counter() - t0:.1f} s")

    # -- phase 7 ------------------------------------------------------------
    t0 = time.perf_counter()
    for d, k in counters.values():
        d[k] = 0
    serving_path(db, served, counters, args)
    serving_launched = {name: d[k] for name, (d, k) in counters.items()}
    log(f"serving path launches: {json.dumps(serving_launched)}")
    if not args.rehearse:
        missing = [k for k, v in serving_launched.items() if v == 0]
        check(not missing, f"never launched on the serving path: {missing}")
    log(f"phase 7 (serving path): {time.perf_counter() - t0:.1f} s")

    # -- phase 8 ------------------------------------------------------------
    t0 = time.perf_counter()
    sharded_launched, sharded_checks = sharded_path(
        db, QUERIES, card, unsharded_ms, counters, args)
    for name, c in sharded_checks.items():
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"],
                                          c["max_abs_err"])
    log(f"sharded path launches (opt-pallas): "
        f"{json.dumps(sharded_launched)}")
    if not args.rehearse:
        check(any(sharded_launched.values()),
              "no kernel launched on the sharded path")
    log(f"phase 8 (sharded path): {time.perf_counter() - t0:.1f} s")

    # -- phase 9 ------------------------------------------------------------
    t0 = time.perf_counter()
    fuzz_phase(args)
    log(f"phase 9 (fuzzer): {time.perf_counter() - t0:.1f} s")

    # -- phase 6 ------------------------------------------------------------
    rows = []
    for name in ENGINE_KERNELS + LIBRARY_KERNELS:
        c = checks[name] if name in checks else library[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launched[name] if name in launched
            else c["launches"],
            "serving_launches": serving_launched.get(name),
            "sharded_launches": sharded_launched.get(name),
            "sharded_rows": sharded_checks.get(name, {}).get("rows"),
            "sharded_max_abs_err": sharded_checks.get(name, {}).get(
                "max_abs_err"),
            "max_abs_err": c["max_abs_err"], "ms": c.get("ms"),
            "device_ms": c.get("device_ms"),
            "kernels_per_call": c.get("kernels_per_call"),
            "memsets_per_call": c.get("memsets_per_call"),
            "host_ms": c.get("host_ms"),
            "plain_ms": c.get("plain_ms"),
            "bound_ms": c["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": c.get("library_ms"),
            "rows": c["n"], "bytes": c["bytes"],
            "path": "engine" if name in ENGINE_KERNELS
            else f"library surface ({c['shape']})"})
    log(json.dumps({"kernels": rows}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if args.rehearse:
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
