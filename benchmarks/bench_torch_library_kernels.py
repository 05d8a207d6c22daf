#!/usr/bin/env python3
"""The library surface's gather and top-k kernels on one card, for any tree.

    python3 benchmarks/bench_torch_library_kernels.py [--src DIR] [--sf 1]

Imports `repro_torch` from `--src`: this checkout's `src/` by default, or
the `src/` of another tree unpacked inside the checkout (a parent commit
under `build/`, made with `git archive`), so that two trees' kernels are
timed by one harness in one call (parent, change, change, parent).  The
shapes are the rows of phase 4b of `chip_smoke.py` (TPC-H at `--sf`, seed
0): `gather_join` of `l_suppkey` into a random supplier x 3 table and of
`l_partkey` into part x 2, and `masked_topk` of `l_extendedprice` under
q3's ship-date mask at k = 10.  For each it prints one JSON line: `ms`
(CUDA events, median of 5 x 10 calls) and `device_ms` and
`kernels_per_call` (torch.profiler over 10 calls), the card's name and
power limit first.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sf", type=float, default=1.0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_library_kernels: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not src.is_relative_to(ROOT):
        print(f"bench_torch_library_kernels: --src {src} is outside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke as cs
    from repro_torch.relational import Database
    from repro_torch.relational.schema import days

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kg, kt = cs.kmod("gather_join"), cs.kmod("topk")
    tree = str(Path(kg.__file__).parents[2])
    print(f"{card}; repro_torch from {tree}", flush=True)

    db = Database.tpch(sf=args.sf, seed=0)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    li = db.table("lineitem")

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def table(k, c):
        return dev_t(rng.normal(size=(k, c)).astype(np.float32))

    calls = {
        "gather_join l_suppkey into supplier x 3": (
            kg.gather_join, dev_t(li.col("l_suppkey")),
            table(db.table("supplier").nrows, 3)),
        "gather_join l_partkey into part x 2": (
            kg.gather_join, dev_t(li.col("l_partkey")),
            table(db.table("part").nrows, 2)),
        "masked_topk l_extendedprice under q3's mask, k=10": (
            kt.masked_topk, dev_t(li.col("l_extendedprice")),
            dev_t(li.col("l_shipdate") > days("1995-03-15")), 10),
    }
    for what, (fn, *a) in calls.items():
        def call(fn=fn, a=a):
            return fn(*a)

        row = {"tree": tree, "card": card, "call": what,
               "ms": cs.time_ms(call)}
        row.update({k: v for k, v in cs.profile_call(call).items()
                    if k in ("device_ms", "kernels_per_call",
                             "memsets_per_call")})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
