#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # TPC-H SF 1, seed 0, on CUDA device 0

Phases (any failure raises; the script then exits non-zero and prints no
result line):

  1. print the card's name and power limit (nvidia-smi);
  2. generate TPC-H at SF 1 and run q1, q3, q6 and q12 at `opt` and
     `opt-pallas` on the CPU — the port's own reference answers — while
     recording the operands the opt-pallas plans hand to each kernel;
  3. build every kernel library (one nvcc per source, all at once);
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
  5. reset the launch counters, run the four queries at both presets on
     the card through `CompiledQuery(...).run()`, compare every answer
     with the CPU answer, and require every kernel to have launched under
     opt-pallas (and none under opt); then time each query;
  6. print one `{"kernels": [...]}` line, and last the result line.

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
it prints no result line.
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
SLICE = ["q1", "q3", "q6", "q12"]
PRESETS = ["opt", "opt-pallas"]
SORT_INSENSITIVE = {"q3"}
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

def cpu_answers(db):
    """Run the slice on the CPU; record every kernel entry point's
    arguments under opt-pallas as (query, entry, args, kwargs)."""
    import repro_torch.kernels.ops as kops
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.relational.queries import QUERIES

    calls = []
    names = ["filter_agg_query", "compact_query", "compact_pred_query",
             "selective_agg_query"]
    saved = {n: getattr(kops, n) for n in names}
    current = [None]

    def recorder(name, fn):
        def g(*a, **k):
            calls.append((current[0], name, a, k))
            return fn(*a, **k)
        return g

    answers = {}
    for n in names:
        setattr(kops, n, recorder(n, saved[n]))
    try:
        for q in SLICE:
            for p in PRESETS:
                current[0] = q if p == "opt-pallas" else None
                t0 = time.perf_counter()
                cq = CompiledQuery(QUERIES[q](), db, preset(p), device="cpu")
                answers[q, p] = cq.run()
                check(cq.n_overflows == 0, (q, p))
                log(f"cpu {q} {p}: {time.perf_counter() - t0:.2f} s")
    finally:
        for n in names:
            setattr(kops, n, saved[n])
    return answers, [c for c in calls if c[0] is not None]


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def to(dev, x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to(dev, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to(dev, v) for v in x)
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
            vm = torch.where(mask[:, None], torch.stack(vals, 1), 0.0)
            lib_out = torch.zeros((G, A), device=mask.device)
            note("filter_agg", err,
                 nbytes(mask, gidx, *vals) + 4 * G * (A + 1),
                 mask.shape[0], {
                     "ms": lambda: kf.filter_agg(mask, gidx, vals, G),
                     "plain_ms": lambda: kf.filter_agg_plain(mask, gidx,
                                                             vals, G),
                     "library_ms": lambda: lib_out.index_add_(0, gidx, vm)})
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
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import CompiledQuery, preset
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
    answers, records = cpu_answers(db)
    seen = {(q, e) for q, e, _a, _k in records}
    for q, e in [("q1", "filter_agg_query"), ("q3", "compact_query"),
                 ("q6", "selective_agg_query"), ("q12", "compact_pred_query"),
                 ("q12", "filter_agg_query")]:
        check((q, e) in seen, f"{q} did not reach {e}")
    subnormal = subnormal_operands(db, dev)

    # -- phase 3 ------------------------------------------------------------
    if not args.rehearse:
        t0 = time.perf_counter()
        sources = build.static_sources()
        for _q, e, a, _k in records:
            a = to(dev, a)
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
    counters = {"compact": (kc.launches, "compact"),
                "compact_pred": (kc.launches, "compact_pred"),
                "filter_agg": (kf.launches, "filter_agg"),
                "selective_filter_agg": (kf.launches, "selective_filter_agg")}
    for d, k in counters.values():
        d[k] = 0
    compiled = {}
    for p in PRESETS:
        for q in SLICE:
            before = {name: d[k] for name, (d, k) in counters.items()}
            cq = CompiledQuery(QUERIES[q](), db, preset(p),
                               device=None if not args.rehearse else "cpu")
            got = cq.run()
            check(cq.n_overflows == 0, (q, p))
            assert_same(got, answers[q, p], q in SORT_INSENSITIVE,
                        f"{q} {p}")
            compiled[q, p] = cq
            delta = {name: d[k] - before[name]
                     for name, (d, k) in counters.items() if d[k] > before[name]}
            log(f"{q} {p}: matches the CPU answer; launches "
                f"{json.dumps(delta)}")
        if p == "opt" and not args.rehearse:
            check(all(d[k] == 0 for d, k in counters.values()),
                  "a kernel launched under opt")
    launched = {name: d[k] for name, (d, k) in counters.items()}
    log(f"main path launches: {json.dumps(launched)}")
    if not args.rehearse:
        missing = [k for k, v in launched.items() if v == 0]
        check(not missing, f"never launched on the main path: {missing}")

    for (q, p), cq in compiled.items():
        sync = torch.cuda.synchronize if not args.rehearse else (lambda: None)
        times = []
        for _ in range(6):
            sync()
            t = time.perf_counter()
            cq.run()
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        log(f"query {q} {p}: median {statistics.median(times[1:]):.3f} ms "
            f"(min {min(times[1:]):.3f}) over {len(times) - 1} runs, "
            f"inputs {cq.input_nbytes()} B")

    # -- phase 6 ------------------------------------------------------------
    rows = []
    for name in ENGINE_KERNELS + LIBRARY_KERNELS:
        c = checks[name] if name in checks else library[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launched[name] if name in launched
            else c["launches"],
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
