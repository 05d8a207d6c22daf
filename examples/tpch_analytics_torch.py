"""End-to-end analytics on the PyTorch port (the counterpart of
`examples/tpch_analytics.py`): load TPC-H, stage every query with the
full optimization pipeline, execute, and report per-query timings,
memory and staging cost.

    PYTHONPATH=src python examples/tpch_analytics_torch.py [--sf 0.05] [--config opt]               # the card
    PYTHONPATH=src python examples/tpch_analytics_torch.py [--sf 0.05] [--config opt] --device cpu

Every rung runs, `opt-pallas` included: on the card it launches the hand
kernels (its first run builds the generated ones with `nvcc`), on the
CPU their plain torch versions.  Without `--device` the script wants
the CUDA card and raises when there is none.
"""
import argparse
import time

from repro_torch.core import CompiledQuery, preset
from repro_torch.core.compile import resolve_device
from repro_torch.relational import Database
from repro_torch.relational.queries import QUERIES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.05)
    ap.add_argument("--config", default="opt",
                    choices=["naive", "template", "tpch", "strdict", "opt",
                             "opt-pallas"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "tpch_analytics_torch")

    t0 = time.perf_counter()
    db = Database.tpch(sf=args.sf)
    print(f"load: {time.perf_counter() - t0:.2f}s  "
          f"({db.base_nbytes() / 1e6:.0f} MB)")

    print(f"{'query':<6} {'rows':>6} {'compile_ms':>11} {'exec_ms':>9} "
          f"{'mem_MB':>7}")
    results = {}
    for name, builder in sorted(QUERIES.items()):
        t0 = time.perf_counter()
        cq = CompiledQuery(builder(), db, preset(args.config), device=device)
        res = cq.run()                # staging, builds, the first run
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = cq.run()
        t_exec = time.perf_counter() - t0
        nrows = len(next(iter(res.values())))
        print(f"{name:<6} {nrows:>6} {t_compile * 1e3:>11.1f} "
              f"{t_exec * 1e3:>9.2f} {cq.input_nbytes() / 1e6:>7.1f}")
        results[name] = res
    return results


if __name__ == "__main__":
    main()
