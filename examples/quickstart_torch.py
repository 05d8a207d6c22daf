"""Quickstart on the PyTorch port: build a TPC-H database, run a query
through the engine ladder, and show the abstraction-without-regret
effect (the port's counterpart of `examples/quickstart.py`).

    PYTHONPATH=src python examples/quickstart_torch.py [--sf 0.02]             # the card
    PYTHONPATH=src python examples/quickstart_torch.py [--sf 0.02] --device cpu

Without `--device` the staged queries run on the CUDA card and the
script raises when there is none.  The Volcano rung is the port's numpy
interpreter, on the host either way.
"""
import argparse
import time

from repro_torch.core import CompiledQuery, VolcanoEngine, preset
from repro_torch.core.compile import resolve_device
from repro_torch.core.ir import plan_repr
from repro_torch.relational import Database
from repro_torch.relational.queries import q6, q12


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.02)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "quickstart_torch")

    print(f"Generating TPC-H (sf={args.sf}) ...")
    db = Database.tpch(sf=args.sf)
    print(f"  lineitem rows: {db.table('lineitem').nrows:,}")

    print("\nQ12 logical plan:")
    print(plan_repr(q12()))

    print("\nInterpreted Volcano engine (the 'DBX' rung):")
    eng = VolcanoEngine(db)
    t0 = time.perf_counter()
    res = eng.execute(q12())
    t_volcano = time.perf_counter() - t0
    print(f"  {dict((k, v[:4]) for k, v in res.items())}")
    print(f"  time: {t_volcano * 1e3:.1f} ms")

    for config in ("naive", "opt"):
        cq = CompiledQuery(q12(), db, preset(config), device=device)
        cq.run()                     # warm up
        t0 = time.perf_counter()
        res = cq.run()               # ends in the host copy of the result
        t = time.perf_counter() - t0
        print(f"\nStaged engine [{config}] on {device}:")
        print(plan_repr(cq.plan))
        print(f"  time: {t * 1e3:.1f} ms  "
              f"(speedup vs volcano: {t_volcano / t:.1f}x)")

    cq = CompiledQuery(q6(), db, preset("opt"), device=device)
    res = cq.run()
    print("\nQ6 [opt] result:", res)
    return res


if __name__ == "__main__":
    main()
