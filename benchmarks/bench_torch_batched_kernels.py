#!/usr/bin/env python3
"""The bind-many pass's batched kernels on one card, for any tree.

    python3 benchmarks/bench_torch_batched_kernels.py [--src DIR]
        [--records FILE] [--sf 1] [--bindings 64] [--reps 5]

Imports `repro_torch` from `--src`: this checkout's `src/` by default,
or the `src/` of another tree unpacked inside the checkout (a parent
commit under `build/`, made with `git archive`), so that two trees'
kernels are timed by one harness in one call (parent, change, change,
parent).  The operands are phase 4c's of `chip_smoke.py`: every batched
kernel call of a two-binding batched pass of each parameterized plan at
`opt-pallas` on the CPU at `--sf` (seed 0), widened to `--bindings`
bindings (batched operands cycled, shared ones kept one copy).  They
are recorded once and kept in `--records` (a `torch.save` file; a later
process, of either tree, loads them), so every tree sees the same
operands.  For each call it prints one JSON line: `ms` (CUDA events,
median of `--reps` x 10 calls), `device_ms`, `kernels_per_call` and
`memsets_per_call` (torch.profiler over 10 calls), `host_ms` (100
unsynchronised calls), the bytes bound as phase 4c counts it and, for
`compact_batched`, `torch.nonzero` of the same masks timed in the same
process (`library_ms`).  A tree whose wrapper reports it adds the staged
instance's clusters, ring and staged columns, or the route a call took.  The card's name and
power limit come first.  Needs a CUDA device.
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
    ap.add_argument("--records", default=str(ROOT / "build" /
                                             "batched_records.pt"))
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--bindings", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_batched_kernels: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not src.is_relative_to(ROOT):
        print(f"bench_torch_batched_kernels: --src {src} is outside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke as cs
    from repro_torch.relational import Database

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kf = cs.kmod("filter_agg")
    tree = str(Path(kf.__file__).parents[2])
    print(f"{card}; repro_torch from {tree}", flush=True)

    records = Path(args.records)
    if records.exists():
        brecords = torch.load(records, weights_only=False)
    else:
        brecords = cs.batched_records(Database.tpch(sf=args.sf, seed=0))
        records.parent.mkdir(parents=True, exist_ok=True)
        torch.save(brecords, records)

    dev = torch.device("cuda")
    for q, name, a, k in brecords:
        mod, _packed, public, _plain, _scalar = cs.BATCHED[name]
        fn_ = getattr(cs.kmod(mod), public)
        wa = cs.widen(cs.to(dev, a), args.bindings)

        def call(wa=wa, fn_=fn_, k=k):
            return fn_(*wa, **k)

        got = call()
        n = next(t for t in (wa[0].values() if isinstance(wa[0], dict)
                             else [wa[0]])).shape[-1]
        nbytes = cs._batched_bytes(name, wa, got)
        row = {"tree": tree, "card": card, "query": q, "name": name,
               "rows": n, "bindings": args.bindings,
               "ms": cs.time_ms(call, reps=args.reps),
               "host_ms": cs.host_ms(call),
               "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        row.update({key: v for key, v in cs.profile_call(call).items()
                    if key != "device_kernels"})
        lib = cs.batched_library_call(name, wa)
        if name == "compact_batched" and lib is not None:
            row["library_ms"] = cs.time_ms(lib, reps=args.reps)
        if name == "selective_filter_agg_batched" and hasattr(
                kf, "selective_batched_info"):
            row["staging"] = kf.selective_batched_info(*wa)
        if name == "filter_agg_batched" and hasattr(
                kf, "filter_agg_batched_info"):
            row["staging"] = kf.filter_agg_batched_info(*wa)
        kc = cs.kmod("compact")
        if name == "compact_pred_batched" and hasattr(kc, "shared_tile"):
            row["staging"] = {"route": "staged" if kc.shared_tile(
                wa[0], wa[4]) else "unstaged"}
        print(json.dumps(row), flush=True)
        del lib, got, wa
    return 0


if __name__ == "__main__":
    sys.exit(main())
