#!/usr/bin/env python3
"""Bind-many's cost on one card, and the engine ladder of any tree.

    python3 scripts/bench_bind_many_torch.py [--sf 1] [--src DIR]
        [--runs 5] [--sizes 1,2,3,4,6,8,16]

Imports `repro_torch` from `--src`: this checkout's `src/` by default,
or the `src/` of another tree unpacked inside the checkout (a parent
commit under `build/`, made with `git archive`), so that two trees are
measured by one harness in one call.  Builds TPC-H at `--sf` (seed 0)
and prints JSON lines, the card's name and power limit first:

- `ladder`: each of the 15 queries at `opt` and `opt-pallas`, timed as
  phase 5 of `chip_smoke.py` times it: the median and minimum of
  `--runs` `run()`s after a warm-up, each synchronised, and the median
  of the device program alone (`execute` and a synchronisation); then
  the sums of the medians by rung.  Any tree.
- `sizes` (a tree with `CompiledQuery.run_batched`): each parameterized
  plan at `opt-pallas`, ms a binding of N scalar walks (N `run`s) and
  of one batched pass (`run_batched`) at each N of `--sizes`, the least
  of 5 each, the bindings the default and the alternative in turn; and
  the crossover, the least N of `--sizes` from which the pass costs no
  more than the walks.
- `windows` (a tree with the batched instances): torch.profiler over
  calls of `compact_batched` (64 random masks of 5,999,771 rows, seed
  0) and `filter_agg_batched` (those masks beside one shared group index
  and two shared value columns), four ways: 10 calls (`plain`, the
  window `chip_smoke.py` took before), one call and a synchronisation
  and then 10 calls in the window (`inner_warmup`), a schedule whose
  first step (one call) is a discarded warm-up and whose second step
  records the 10 (`schedule`), and 10 calls each synchronised
  (`sync_each`): the device kernels and memsets each window recorded
  against the host's launch calls, and the start of each launch call
  and of each recorded kernel in µs from the window's first launch.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNGS = ("opt", "opt-pallas")
N_ROWS = 5_999_771


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def timed(fn, runs: int, sync) -> list[float]:
    """ms of `runs` calls of `fn` after one warm-up, each synchronised."""
    fn()
    out = []
    for _ in range(runs):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def least_ms(fn, sync, reps: int = 5) -> float:
    fn()
    sync()
    best = None
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        best = ms if best is None else min(best, ms)
    return best


def ladder(db, runs: int, sync) -> None:
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.relational.queries import QUERIES

    sums: dict = {}
    for p in RUNGS:
        for q in sorted(QUERIES, key=lambda s: (len(s), s)):
            cq = CompiledQuery(QUERIES[q](), db, preset(p))
            run_ms = timed(cq.run, runs, sync)
            inputs = cq.bind()
            exec_ms = timed(lambda: cq.execute(inputs), runs, sync)
            del inputs, cq
            med = statistics.median(run_ms)
            sums[p] = sums.get(p, 0.0) + med
            emit({"part": "ladder", "query": q, "preset": p,
                  "median_ms": med, "min_ms": min(run_ms),
                  "execute_median_ms": statistics.median(exec_ms)})
    emit({"part": "ladder", "sum_of_medians_ms": sums})


def sizes(db, sizes_: list[int], sync) -> None:
    from repro_torch.core import PlanCache, preset
    from repro_torch.relational.queries import (PARAM_ALT_BINDINGS,
                                                PARAM_QUERIES)

    cache = PlanCache(db)
    crossover = {}
    try:
        for q in sorted(PARAM_QUERIES):
            build, defaults = PARAM_QUERIES[q]
            cq, _rt = cache.get(build(), preset("opt-pallas"), defaults)
            both = (dict(defaults), dict(defaults, **PARAM_ALT_BINDINGS[q]))
            rts = [{k: b[k] for k in cq.param_spec} for b in both]
            for n in sizes_:
                bl = [rts[i % 2] for i in range(n)]
                walks = least_ms(lambda: [cq.run(b) for b in bl], sync)
                batched = least_ms(lambda: cq.run_batched(bl), sync)
                if batched <= walks and q not in crossover:
                    crossover[q] = n
                emit({"part": "sizes", "query": q, "bindings": n,
                      "walks_ms_per_binding": walks / n,
                      "pass_ms_per_binding": batched / n})
    finally:
        cache.close()
    emit({"part": "sizes", "crossover": crossover})


def windows() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    kc = importlib.import_module("repro_torch.kernels.compact")
    kf = importlib.import_module("repro_torch.kernels.filter_agg")
    g = torch.Generator(device="cuda").manual_seed(0)
    mask = torch.rand(64, N_ROWS, generator=g, device="cuda") < 0.5
    gidx = torch.randint(0, 4, (N_ROWS,), generator=g, device="cuda",
                         dtype=torch.int32)
    vals = [torch.rand(N_ROWS, generator=g, device="cuda")
            for _ in range(2)]
    fns = {"compact_batched": lambda: kc.compact_batched(mask, 1 << 22),
           "filter_agg_batched": lambda: kf.filter_agg_batched(
               mask, gidx, vals, 4)}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def tally(prof, calls: int) -> dict:
        evs = [e for e in prof.events()]
        launches = sorted(e.time_range.start for e in evs
                          if e.device_type == DeviceType.CPU
                          and e.name.startswith("cudaLaunchKernel"))
        kern = sorted(e.time_range.start for e in evs
                      if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memset", "Memcpy")))
        memsets = [e for e in evs if e.device_type == DeviceType.CUDA
                   and e.name.startswith("Memset")]
        t0 = launches[0] if launches else 0
        return {"calls": calls, "launch_calls": len(launches),
                "kernels": len(kern), "memsets": len(memsets),
                "launch_us": [round(t - t0, 1) for t in launches],
                "kernel_us": [round(t - t0, 1) for t in kern]}

    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        emit({"part": "windows", "kernel": name, "way": "plain",
              **tally(prof, 10)})
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        emit({"part": "windows", "kernel": name, "way": "inner_warmup",
              **tally(prof, 11)})
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            prof.step()
        emit({"part": "windows", "kernel": name, "way": "schedule",
              **tally(prof, 10)})
        with profile(activities=acts) as prof:
            for _ in range(10):
                fn()
                torch.cuda.synchronize()
        emit({"part": "windows", "kernel": name, "way": "sync_each",
              **tally(prof, 10)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sizes", default="1,2,3,4,6,8,16")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_bind_many_torch: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not src.is_relative_to(ROOT):
        print(f"bench_bind_many_torch: --src {src} is outside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core import CompiledQuery
    from repro_torch.relational import Database
    # the module, not the function the package exports under its name
    kc = importlib.import_module("repro_torch.kernels.compact")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"card": card, "torch": torch.__version__,
          "repro_torch": str(Path(kc.__file__).parents[2])})
    sync = torch.cuda.synchronize
    db = Database.tpch(sf=args.sf, seed=0)
    ladder(db, args.runs, sync)
    if hasattr(CompiledQuery, "run_batched"):
        sizes(db, [int(s) for s in args.sizes.split(",")], sync)
    if hasattr(kc, "compact_batched"):
        windows()
    return 0


if __name__ == "__main__":
    sys.exit(main())
