"""The lower-precision control of the check: the plain reference computed
in bfloat16 (the nearest precision below the configurations' float32)
put in the program's place, over the requests a run of the cell sends,
judged by the same comparison against the float64 reference.  It has to
come out not correct; its readings set the upper end of `float_gap`'s
limit.

    python3 bench/control.py --workload adhoc-power --seeds 11 12 13

Prints one JSON line a seed: the control's `answers_wrong` and
`float_gap`, and each query's widest gap.  It runs no program, so it
needs no window: it judges the first `--requests` requests of the seed's
traffic, at most `check_max_bindings` distinct bindings, as a run does.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seed: int, device: str, scale=None,
             n_requests: int = 4000, root: Path = ROOT) -> dict:
    """The control's numbers for one seed of `workload`."""
    import torch

    from bench import compare, manifest, reference, tpchgen

    cell = manifest.load(workload, root)
    config = cell.config
    arrays = tpchgen.generate(scale if scale is not None
                              else config["scale_factor"], seed)
    source = cell.generator.Requests(cell.traffic, seed, 0)
    bindings: dict = {}
    for _ in range(n_requests):
        q, params = source.next()
        bindings.setdefault((q, tuple(sorted((params or {}).items()))),
                            None)
    keys = list(bindings)[:int(config.get("check_max_bindings", 400))]
    ref = reference.Reference(arrays, device)
    ctl = reference.Reference(arrays, device, fdt=torch.bfloat16)
    wrong, gap, per_query = 0, 0.0, {}
    for q, frozen in keys:
        params = dict(frozen) or None
        n = reference.limit(q, params)
        got = ctl.answer(q, params)
        if n is not None:
            got = {k: v[:n] for k, v in got.items()}
        why, g = compare.judge(got, ref.answer(q, params), reference.SORT[q],
                               reference.FLOAT_COLUMNS[q], n)
        wrong += why is not None
        gap = max(gap, g)
        per_query[q] = max(per_query.get(q, 0.0), g)
    return {"workload": workload, "seed": seed, "bindings": len(keys),
            "answers_wrong": wrong, "float_gap": gap,
            "float_gap_by_query": per_query}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=4000)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, device,
                                  n_requests=args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
