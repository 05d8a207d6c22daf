#!/usr/bin/env python3
"""How far each way of summing q1's aggregation lands from the exact sum.

    python3 benchmarks/bench_torch_agg_accuracy.py [--sf 1]

Records every `filter_agg` call of q1 at `opt-pallas` (TPC-H at `--sf`,
seed 0), unsharded and on 2 virtual slots of cuda:0 (one call a shard),
and sums each call's operands four ways: the CUDA kernel, its plain
version (`filter_agg_plain`), a float32 `index_add_` (row by row into
one running sum a group) and a float64 `index_add_`, the exact sum the
others are held against.  Prints one JSON line a call and a way: the
largest absolute error, and the largest error relative to the exact
sum, with the group and column where it falls.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def record_calls(db, shards: int, dev) -> list:
    """Copies of the operands of every `filter_agg` call of q1."""
    import repro_torch.kernels.ops as kops
    from repro_torch.core import CompiledQuery, mesh, preset
    from repro_torch.relational.queries import QUERIES

    calls = []
    real = kops.filter_agg_query

    def rec(mask, gidx, vals, G):
        calls.append((mask.clone(), gidx.to(dev, copy=True),
                      [v.to(dev, copy=True) for v in vals], G))
        return real(mask, gidx, vals, G)

    kops.filter_agg_query = rec
    try:
        if shards > 1:
            mesh.virtual_devices("cuda:0", shards)
        CompiledQuery(QUERIES["q1"](), db, dataclasses.replace(
            preset("opt-pallas"), shards=shards)).run()
    finally:
        kops.filter_agg_query = real
        mesh.virtual_devices("cuda:0", 1)
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_agg_accuracy: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import importlib

    from repro_torch.relational import Database

    kf = importlib.import_module("repro_torch.kernels.filter_agg")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    db = Database.tpch(sf=args.sf, seed=0)
    for shards in (1, 2):
        for i, (mask, gidx, vals, G) in enumerate(record_calls(db, shards,
                                                               dev)):
            g32 = gidx.to(torch.int32)
            cols = [v.to(torch.float32).contiguous() for v in vals]
            v32 = torch.stack(cols, 1)
            ok = mask & (g32 >= 0) & (g32 < G)
            g = g32.clamp(0, G - 1)

            def index_add(dtype):
                out = torch.zeros((G, v32.shape[1]), dtype=dtype, device=dev)
                return out.index_add_(0, g, torch.where(
                    ok[:, None], v32.to(dtype), 0.0))

            exact = index_add(torch.float64)
            ways = {"kernel": kf.filter_agg(mask, g32, cols, G)[0],
                    "plain": kf.filter_agg_plain(mask, g32, cols, G)[0],
                    "index_add_float32": index_add(torch.float32)}
            for way, got in ways.items():
                err = (got.double() - exact).abs()
                rel = err / exact.abs().clamp_min(1e-30)
                at = divmod(int(rel.argmax()), v32.shape[1])
                print(json.dumps({
                    "shards": shards, "call": i, "rows": mask.shape[0],
                    "groups": G, "columns": v32.shape[1], "way": way,
                    "max_abs_err": float(err.max()),
                    "max_rel_err": float(rel.max()),
                    "at": {"group": at[0], "column": at[1],
                           "exact": float(exact[at])}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
