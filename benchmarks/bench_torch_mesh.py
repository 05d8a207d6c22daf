#!/usr/bin/env python3
"""Where a sharded query's time goes on one card: the mesh, the
collectives and the staged walks.

    python3 benchmarks/bench_torch_mesh.py [--sf 1]

On n virtual slots of cuda:0 (n = 2 and 4) it prints one JSON line a
measurement, each the median (and minimum) of many calls on the host
clock:

  * `mesh_run`: `DataMesh.run` of a function that does nothing (thread
    start, device and stream set-up, join);
  * `psum`: the same with one `psum` of a 0-d CUDA tensor a shard (the
    rendezvous: two barrier waits and a rank-order add);
  * for q1, q6, q12 and q14 at `opt-pallas` (TPC-H at `--sf`, seed 0),
    unsharded and on n slots: `run()` (synchronised, decode included),
    `execute` with a synchronisation (the device program), and
    `execute` alone (the host's enqueue, no synchronisation inside), and
    the device time a run under torch.profiler.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
QUERIES_TIMED = ["q1", "q6", "q12", "q14"]


def _ms(fn, reps: int, sync) -> list[float]:
    fn()
    sync()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def _line(what: str, ms: list[float], **extra) -> None:
    print(json.dumps({"what": what, "median_ms": statistics.median(ms),
                      "min_ms": min(ms), "n": len(ms), **extra}),
          flush=True)


def _device_ms(fn, calls: int = 5) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_mesh: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import CompiledQuery, mesh, preset
    from repro_torch.core.backend import TorchBackend
    from repro_torch.relational import Database
    from repro_torch.relational.queries import QUERIES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0],
          flush=True)
    sync = torch.cuda.synchronize
    nothing = lambda: None     # noqa: E731
    db = Database.tpch(sf=args.sf, seed=0)
    base = {q: CompiledQuery(QUERIES[q](), db, preset("opt-pallas"))
            for q in QUERIES_TIMED}
    for q, cq in base.items():
        inputs = cq.bind()
        _line(f"{q} run", _ms(cq.run, 20, sync), shards=1)
        _line(f"{q} execute+sync", _ms(lambda: cq.execute(inputs), 20,
                                       sync), shards=1)
        _line(f"{q} execute", _ms(lambda: cq.execute(inputs), 20, nothing),
              shards=1, device_ms=_device_ms(lambda: cq.execute(inputs)))
    for n in (2, 4):
        mesh.virtual_devices("cuda:0", n)
        m = mesh.data_mesh(n, "cuda:0")
        _line("mesh_run", _ms(lambda: m.run(lambda r, g, x: None,
                                            [None] * n), 200, sync),
              shards=n)
        one = torch.ones((), device="cuda:0")

        def psum(rank, group, x):
            return TorchBackend("cuda:0", group, rank).psum(x, mesh.AXIS)
        _line("psum", _ms(lambda: m.run(psum, [one] * n), 200, sync),
              shards=n)
        for q in QUERIES_TIMED:
            cq = CompiledQuery(QUERIES[q](), db, dataclasses.replace(
                preset("opt-pallas"), shards=n))
            inputs = cq.bind()
            _line(f"{q} run", _ms(cq.run, 20, sync), shards=n)
            _line(f"{q} execute+sync", _ms(lambda: cq.execute(inputs), 20,
                                           sync), shards=n)
            _line(f"{q} execute", _ms(lambda: cq.execute(inputs), 20,
                                      nothing), shards=n,
                  device_ms=_device_ms(lambda: cq.execute(inputs)))
            del cq, inputs
    mesh.virtual_devices("cuda:0", 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
