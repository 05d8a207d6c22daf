#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's queries goes, on one card.

    python3 benchmarks/profile_torch_queries.py [--sf 1] [--runs 5]

Builds TPC-H at `--sf` (seed 0), then for q1, q3, q6 and q12 at `opt` and
`opt-pallas`: warms the query up once, runs it `--runs` times under
`torch.profiler` (CPU and CUDA activity), and prints one JSON line per
query with the wall time per run (host clock, synchronized), the device
time per run (sum of the kernels' own device time; one stream, so
kernels do not overlap), the device's busy share of the wall time, and
the kernels that take most of the device time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.relational import Database
    from repro_torch.relational.queries import QUERIES

    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)
    db = Database.tpch(sf=args.sf, seed=0)
    for p in ("opt", "opt-pallas"):
        for q in ("q1", "q3", "q6", "q12"):
            cq = CompiledQuery(QUERIES[q](), db, preset(p))
            cq.run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.runs):
                    cq.run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / args.runs * 1e3
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_us = sum(e.self_device_time_total for e in kernels)
            dev = dev_us / 1e3 / args.runs
            top = sorted(kernels, key=lambda e: e.self_device_time_total,
                         reverse=True)[:args.top]
            print(json.dumps({
                "query": q, "preset": p, "sf": args.sf,
                "wall_ms_per_run": wall, "device_ms_per_run": dev,
                "device_busy_share": dev / wall if wall else None,
                "kernel_launches_per_run": sum(e.count for e in kernels)
                / args.runs,
                "top": [{"kernel": e.key[:90],
                         "ms_per_run": e.self_device_time_total / 1e3
                         / args.runs,
                         "calls_per_run": e.count / args.runs}
                        for e in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
