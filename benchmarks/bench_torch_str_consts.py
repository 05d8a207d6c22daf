#!/usr/bin/env python3
"""Queries whose predicates compare char-matrix strings, at `naive`.

    python3 benchmarks/bench_torch_str_consts.py [--src DIR]

At `naive` (`string_dict=False`) a CAT or TEXT predicate compares a
(n, w) byte matrix with the constant's bytes: StrEq and StrIn values,
prefixes and LIKE words.  This script times q12, q13, q14 and q19 there
on the card at TPC-H SF 1 (seed 0): per query one JSON line with
`run()`'s median and minimum over 5 runs after one warm-up (host clock,
synchronized).  It imports `repro_torch` from `--src` (this checkout's
`src/` by default, or that of another tree unpacked inside the
checkout, such as a parent commit under `build/`), so that two trees'
string constants are compared by one harness in one call.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
QUERIES_WITH_STRINGS = ["q12", "q13", "q14", "q19"]
RUNS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_str_consts: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not src.is_relative_to(ROOT):
        print(f"bench_torch_str_consts: --src {src} is outside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.relational import Database
    from repro_torch.relational.queries import QUERIES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; src {src.relative_to(ROOT)}", flush=True)
    db = Database.tpch(sf=1.0, seed=0)
    for q in QUERIES_WITH_STRINGS:
        cq = CompiledQuery(QUERIES[q](), db, preset("naive"))
        cq.run()
        torch.cuda.synchronize()
        lat = []
        for _ in range(RUNS):
            t = time.perf_counter()
            cq.run()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        print(json.dumps({"query": q, "preset": "naive",
                          "src": str(src.relative_to(ROOT)),
                          "latency_ms_median": statistics.median(lat),
                          "latency_ms_min": min(lat), "runs": RUNS}),
              flush=True)
        del cq
    return 0


if __name__ == "__main__":
    sys.exit(main())
