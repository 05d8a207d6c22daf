#!/usr/bin/env python3
"""The generated compact_pred kernel at three tile sizes, on one card.

    python3 benchmarks/bench_torch_compact_tiles.py [--sf 1]

Builds TPC-H at `--sf` (seed 0) and runs q3 and q12 at `opt-pallas` on
the card once, recording the operands the engine hands to the compaction
entry points: q12's predicate over its columns (compact_pred) and q3's
largest mask.  The mask is compacted through the same generated kernel,
as the predicate `m` over the one bool column `m`, so both shapes are
measured on one instance.  The port's tile is fixed (`kCompactRows`,
4,096 rows); this script builds its own variants of the generated
library with `compact.cuh`'s `kCompactItems` set to 16, 8 and 4 items a
thread (4,096, 2,048 and 1,024 rows a tile), inlined in the source, and
calls them with a workspace sized for their tile.  For each shape and
tile it checks the result against the plain version (exact) and prints
one JSON line: `ms` (CUDA events, median of 5 x 10 calls), `host_ms`
(host clock around 100 calls, no synchronisation inside), `device_ms`,
`kernels_per_call` and `memsets_per_call` (torch.profiler over 10
calls; a window that lost events is taken again, and more than one
kernel and one memset a call fails).  The static `compact` library is
timed on q3's mask beside them.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILES = (4096, 2048, 1024)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_torch_compact_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (check, host_ms, max_err, one_kernel_a_call,
                            time_ms)
    from repro_torch.core import CompiledQuery, preset
    from repro_torch.core.expr import Col
    from repro_torch.core.operators.fused import TileFn
    from repro_torch.kernels import build, codegen
    from repro_torch.kernels import ops as kops
    from repro_torch.relational import Database
    from repro_torch.relational.queries import QUERIES

    kc = importlib.import_module("repro_torch.kernels.compact")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    db = Database.tpch(sf=args.sf, seed=0)
    seen = {}
    real = {n: getattr(kops, n) for n in ("compact_pred_query",
                                          "compact_query")}

    def recorder(name):
        def g(*a, **k):
            n = (next(iter(a[0].values())) if name == "compact_pred_query"
                 else a[0]).shape[0]
            if name not in seen or n > seen[name][0]:
                seen[name] = (n, a, k)
            return real[name](*a, **k)
        return g

    for name in real:
        setattr(kops, name, recorder(name))
    try:
        for q in ("q3", "q12"):
            CompiledQuery(QUERIES[q](), db, preset("opt-pallas")).run()
    finally:
        for name, fn in real.items():
            setattr(kops, name, fn)

    _n, (cols, scalars, pred, cap), kw = seen["compact_pred_query"]
    _n, (mask, mcap), mkw = seen["compact_query"]
    shapes = {
        "q12 predicate": (cols, scalars, pred, cap,
                          kw.get("translate", False)),
        "q3 mask as a predicate": ({"m": mask}, [], TileFn(Col("m"), []),
                                   mcap, mkw.get("translate", False)),
    }
    header = (build.CSRC / "compact.cuh").read_text()
    items_line = "constexpr int kCompactItems = 16;"
    check(header.count(items_line) == 1, "compact.cuh names its items once")

    def variant(pred_src: str, tile: int) -> str:
        """The generated source with compact.cuh inlined at `tile` rows a
        tile."""
        body = header.replace("#pragma once", "").replace(
            items_line, f"constexpr int kCompactItems = {tile // 256};")
        check(pred_src.count('#include "compact.cuh"') == 1,
              "the generated source includes compact.cuh once")
        return pred_src.replace('#include "compact.cuh"', body)

    names = {}
    for label, (c, s, p, _cap, _tr) in shapes.items():
        _name, src = kc.pred_source(c, s, p)
        for tile in TILES:
            names[label, tile] = (f"compact_pred_tile{tile}",
                                  variant(src, tile))
    build.build_all(list(names.values()) + build.static_sources())

    def tile_call(lib, c, s, p, cp, tr, tile):
        first = next(iter(c.values()))
        n = first.shape[0]
        head = 2 * -(-n // tile) + 2
        ws = torch.empty(head + cp + (n if tr else 0), dtype=torch.int32,
                         device=first.device)
        fp, ip = codegen.split_scalars(p.param_names, s)
        build.check(lib.repro_compact_pred(
            (ctypes.c_void_p * len(c))(*[t.data_ptr() for t in c.values()]),
            (ctypes.c_double * max(len(fp), 1))(*fp),
            (ctypes.c_longlong * max(len(ip), 1))(*ip),
            n, build.ptr(ws), ws.shape[0], cp, int(tr),
            build.stream_ptr(first)), "compact_pred")
        out = (ws[head:head + cp], ws[head - 1])
        return out + ((ws[head + cp:head + cp + n],) if tr else ())

    def measure(name, call):
        call()
        row = {"ms": time_ms(call), "host_ms": host_ms(call)}
        row.update({k: v for k, v in one_kernel_a_call(name, call, 1).items()
                    if k != "device_kernels"})
        return row

    for label, (c, s, p, cp, tr) in shapes.items():
        want = kc.compact_pred_plain(c, s, p, cp, tr)
        n = next(iter(c.values())).shape[0]
        for tile in TILES:
            lib = build.load(*names[label, tile])
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.repro_compact_pred.argtypes = [vp, vp, vp, ll, vp, ll, i, i,
                                               vp]
            lib.repro_compact_pred.restype = ctypes.c_int

            def call(lib=lib, c=c, s=s, p=p, cp=cp, tr=tr, tile=tile):
                return tile_call(lib, c, s, p, cp, tr, tile)

            for r in range(3):
                check(max_err(call(), want, f"{label}, tile {tile}, #{r}")
                      == 0.0, f"{label}, tile {tile}")
            row = {"shape": label, "rows": n, "capacity": cp,
                   "translate": tr, "tile_rows": tile, "card": card}
            row.update(measure(f"{label}, tile {tile}", call))
            print(json.dumps(row), flush=True)
    want = kc.compact_plain(mask, mcap, mkw.get("translate", False))

    def static():
        return kc.compact(mask, mcap, translate=mkw.get("translate", False))

    check(max_err(static(), want, "static compact") == 0.0, "static compact")
    row = {"shape": "q3 mask, static compact", "rows": mask.shape[0],
           "capacity": mcap, "tile_rows": kc.TILE_ROWS, "card": card}
    row.update(measure("static compact", static))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
