"""Finds the knee of an open-loop cell: the highest Poisson rate at which
the program keeps up.  One process sets up once and runs the cell's mix
at each rate given, for the cell's warm-up and then `--seconds`:

    python3 bench/sweep.py --workload <cell> --traffic <open-loop mix> \\
        --seed 7 --seconds 10 --rates 60 90 120 150

`--workload` names a cell whose configuration serves the mix, and
`--traffic` an open-loop mix under `bench/traffic/` (the cell's own
where left out).

A rate is sustained where, over its window, requests answered are at
least 98 % of those due, the requests outstanding grow by at most 2 % of
those due, none failed, was refused or was served by a degraded plan,
and the 95th percentile from due time to answer is at most `--p95-ms`.
Prints one JSON line a rate, then the knee.  A cell's traffic file keeps
0.8 times the knee, found once when the cell was defined.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def outstanding(requests: list, t: float) -> int:
    return sum(1 for r in requests
               if r.sent <= t and (math.isnan(r.done) or r.done > t))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--traffic")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--p95-ms", type=float, default=500.0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness, manifest, stats

    cell = manifest.load(args.workload, ROOT)
    if args.traffic:
        cell.traffic = json.loads((ROOT / "bench" / "traffic" /
                                   f"{args.traffic}.json").read_text())
    if cell.traffic["loop"] != "open":
        print("the traffic is not an open loop", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _arrays, client, setup = harness.set_up(cell, args.seed, dev, None,
                                            T_START)
    print(json.dumps({"setup": setup}), flush=True)
    knee = None
    for rate in args.rates:
        traffic = dict(cell.traffic, rate_per_s=rate)
        _loop, run, _p0, _p1 = harness.measure(
            cell, client, traffic, args.seed, args.seconds, dev)
        due = run.due()
        growth = outstanding(run.requests, run.t_close) \
            - outstanding(run.requests, run.t_open)
        failed = sum(1 for r in due if not r.ok)
        c = run.counters
        row = {"rate_per_s": rate, "due": len(due),
               "answered_share": len(run.completed()) / max(len(due), 1),
               "outstanding_growth": growth, "failed": failed,
               "rejected": c.get("rejected", 0),
               "shed_plan": c.get("shed_plan", 0),
               "shed_batch": c.get("shed_batch", 0),
               "requests_per_batch": stats.per_batch(run),
               "p95_ms": stats.percentile(stats.latencies_ms(run), 95),
               "p50_ms": stats.percentile(stats.latencies_ms(run), 50),
               "sender_late_s": max((r.sent - r.due for r in due),
                                    default=0.0)}
        row["sustained"] = (row["answered_share"] >= 0.98
                            and growth <= 0.02 * len(due) and failed == 0
                            and row["rejected"] == 0
                            and row["shed_plan"] == 0
                            and row["p95_ms"] <= args.p95_ms)
        if row["sustained"] and (knee is None or rate > knee):
            knee = rate
        print(json.dumps({k: (v if not isinstance(v, float)
                              or math.isfinite(v) else None)
                          for k, v in row.items()}), flush=True)
    print(json.dumps({"knee_per_s": knee}), flush=True)
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
