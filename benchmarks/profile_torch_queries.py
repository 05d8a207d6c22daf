#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's queries goes, on one card:
the engine ladder (the paper's Table III) for every query.

    python3 benchmarks/profile_torch_queries.py [--sf 1] [--runs 5]

Builds TPC-H at `--sf` (seed 0).  For all 15 queries at every compiled
rung (`naive`, `template`, `tpch`, `strdict`, `opt`, `opt-pallas`), and
for the row layout of q1, q6, q12 and q19 at `naive`, `opt` and
`opt-pallas`: builds the query, warms it up once, times
`--runs` runs of `run()` (host clock, synchronized: median and minimum),
then runs it `--runs` times more under `torch.profiler` (CPU and CUDA
activity) and prints one JSON line with the device time per run (sum of
the kernels' own device time; one stream, so kernels do not overlap),
the device's busy share of the profiled wall time, the launches and the
sorts (`aten::sort` calls) per run, and the kernels that take most of
the device time.  The query is freed before the next is built.

The `dbx` rung is the port's Volcano engine on the host, at SF 0.1 (an
interpreted pass over all 15 queries at SF 1 takes minutes), timed the
same way without the profiler.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNGS = ["naive", "template", "tpch", "strdict", "opt", "opt-pallas"]
ROW_RUNGS = ["naive", "opt", "opt-pallas"]
# the queries that reach the generated kernels, whose loads the row
# layout makes strided
ROW_QUERIES = ["q1", "q6", "q12", "q19"]
DBX_SF = 0.1


def timed(fn, runs: int, sync) -> list[float]:
    """ms of `runs` calls of `fn` after one warm-up, each synchronized."""
    fn()
    sync()
    out = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_queries: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import CompiledQuery, VolcanoEngine, preset
    from repro_torch.relational import Database
    from repro_torch.relational.queries import QUERIES

    queries = sorted(QUERIES)
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)
    db = Database.tpch(sf=args.sf, seed=0)
    configs = [(q, p, "column") for p in RUNGS for q in queries] \
        + [(q, p, "row") for p in ROW_RUNGS for q in ROW_QUERIES]
    for q, p, layout in configs:
        t_build = time.perf_counter()
        cq = CompiledQuery(QUERIES[q](), db,
                           dataclasses.replace(preset(p), layout=layout))
        cq.run()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t_build
        lat = timed(cq.run, args.runs, torch.cuda.synchronize)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.runs):
                cq.run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.runs * 1e3
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        sorts = sum(e.count for e in events if e.key == "aten::sort")
        dev = sum(e.self_device_time_total for e in kernels) / 1e3 \
            / args.runs
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:args.top]
        print(json.dumps({
            "query": q, "preset": p, "layout": layout, "sf": args.sf,
            "latency_ms_median": statistics.median(lat),
            "latency_ms_min": min(lat), "runs": len(lat),
            "build_and_first_run_s": build_s,
            "n_overflows": cq.n_overflows,
            "wall_ms_per_run": wall, "device_ms_per_run": dev,
            "device_busy_share": dev / wall if wall else None,
            "kernel_launches_per_run": sum(e.count for e in kernels)
            / args.runs,
            "sorts_per_run": sorts / args.runs,
            "top": [{"kernel": e.key[:90],
                     "ms_per_run": e.self_device_time_total / 1e3
                     / args.runs,
                     "calls_per_run": e.count / args.runs}
                    for e in top]}), flush=True)
        del cq
    vdb = db if DBX_SF == args.sf else Database.tpch(sf=DBX_SF, seed=0)
    eng = VolcanoEngine(vdb)
    for q in queries:
        lat = timed(lambda: eng.execute(QUERIES[q]()), args.runs,
                    lambda: None)
        print(json.dumps({
            "query": q, "preset": "dbx", "layout": "column",
            "sf": DBX_SF, "latency_ms_median": statistics.median(lat),
            "latency_ms_min": min(lat), "runs": len(lat),
            "device_ms_per_run": None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
