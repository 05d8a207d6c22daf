#!/usr/bin/env python3
"""The four engine kernel entry points' cost on the host and on the card.

    python3 benchmarks/bench_torch_host.py [--sf 1] [--src DIR]

Imports `repro_torch` from `--src`: this checkout's `src/` by default,
or the `src/` of another tree unpacked inside the checkout (a parent
commit under `build/`, made with `git archive`).  `chip_smoke.py`
reports `host_ms` too, but only for its own tree and only where its own
version has the field; this script measures any tree's wrappers by one
harness, so that two trees' host costs are compared by the same code in
one call.  It builds TPC-H at `--sf` (seed 0) and
runs q1, q3, q6 and q12 at `opt-pallas` on the card once, recording the
arguments of every call of the engine's kernel entry points
(`repro_torch.kernels.ops`: `compact_query`, `compact_pred_query`,
`filter_agg_query`, `selective_agg_query`).  For the largest call of each
it prints one JSON line: `host_ms` (host clock around 100 back-to-back
calls with no synchronisation inside, per call: the wrapper's own cost),
`ms` (CUDA events, median of 5 x 10 calls), and `device_ms`,
`kernels_per_call` and `memsets_per_call` (torch.profiler over 10
calls).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENTRIES = ("compact_query", "compact_pred_query", "filter_agg_query",
           "selective_agg_query")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    src = Path(args.src).resolve()
    if not src.is_relative_to(ROOT):
        print(f"bench_torch_host: --src {src} is outside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from chip_smoke import host_ms, profile_call, time_ms
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.kernels import ops as kops
    from repro_torch.relational import Database
    from repro_torch.relational.queries import QUERIES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; repro_torch from {Path(kops.__file__).parents[2]}",
          flush=True)

    db = Database.tpch(sf=args.sf, seed=0)
    seen = {}
    real = {e: getattr(kops, e) for e in ENTRIES}

    def recorder(entry):
        def g(*a, **k):
            first = a[0] if isinstance(a[0], torch.Tensor) \
                else next(iter(a[0].values()))
            n = first.shape[0]
            if entry not in seen or n > seen[entry][0]:
                seen[entry] = (n, a, k)
            return real[entry](*a, **k)
        return g

    for e in ENTRIES:
        setattr(kops, e, recorder(e))
    try:
        for q in ("q1", "q3", "q6", "q12"):
            CompiledQuery(QUERIES[q](), db, preset("opt-pallas")).run()
    finally:
        for e, fn in real.items():
            setattr(kops, e, fn)

    for e in ENTRIES:
        n, a, k = seen[e]

        def call(e=e, a=a, k=k):
            return real[e](*a, **k)

        row = {"entry": e, "rows": n, "card": card,
               "host_ms": host_ms(call), "ms": time_ms(call)}
        row.update({key: v for key, v in profile_call(call).items()
                    if key != "device_kernels"})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
