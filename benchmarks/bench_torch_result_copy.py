#!/usr/bin/env python3
"""The two ways to bring a query's result from the card to the host.

    python3 benchmarks/bench_torch_result_copy.py

`CompiledQuery.run()` copies a result frame of more than
`compile.DEVICE_SELECT_ROWS` rows by `valid_rows_to_host` (the valid
rows selected on the device: `nonzero`, then `index_select` of every
column), and a smaller one by `whole_to_host` (every column and the
mask copied whole, the rows selected on the host).  For all 15 queries at `naive` (whose generic
aggregation pads its result to the input's row count) and at
`opt-pallas` (results of one to a few thousand rows), at TPC-H SF 1
(seed 0), this script executes the query once and then times both ways
on the same outputs, alternating which goes first: per query and rung
one JSON line with the frame's rows, its valid rows, and each way's
median and minimum over 20 calls (host clock, synchronized before and
after; both end with numpy arrays of the valid rows, checked equal).
Needs a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNGS = ["naive", "opt-pallas"]
CALLS = 20


def valid_rows(copy, out, mask):
    cols, host_mask = copy(out, mask)
    return {k: v[host_mask] for k, v in cols.items()}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_result_copy: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.core.compile import valid_rows_to_host, whole_to_host
    from repro_torch.relational import Database
    from repro_torch.relational.queries import QUERIES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    db = Database.tpch(sf=1.0, seed=0)
    for p in RUNGS:
        for q in sorted(QUERIES):
            cq = CompiledQuery(QUERIES[q](), db, preset(p))
            out, mask, _ = cq.execute(cq.bind())
            torch.cuda.synchronize()
            ways = [("on_device", valid_rows_to_host),
                    ("whole", whole_to_host)]
            a, b = (valid_rows(fn, out, mask) for _, fn in ways)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            ms = {name: [] for name, _ in ways}
            for i in range(CALLS):
                for name, fn in ways[::1 if i % 2 == 0 else -1]:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    valid_rows(fn, out, mask)
                    torch.cuda.synchronize()
                    ms[name].append((time.perf_counter() - t) * 1e3)
            row = {"query": q, "preset": p, "rows": int(mask.shape[0]),
                   "valid_rows": int(mask.sum())}
            for name, v in ms.items():
                row[f"{name}_ms_median"] = statistics.median(v)
                row[f"{name}_ms_min"] = min(v)
            print(json.dumps(row), flush=True)
            del cq, out, mask
    return 0


if __name__ == "__main__":
    sys.exit(main())
