"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; the cells are `BENCHMARK.json`'s
`workloads`.  Prints the run's set-up, window and check on standard
error, the numbers compared beside their limits last, and one JSON
object as the last line of standard output.  Exits with 2, printing no
result, where the machine has fewer CUDA devices than the cell asks for,
and with 1 where the run cannot give one.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # caches that torch's compilers would write go inside the checkout, at
    # fixed paths, set here because a later change to the program may not
    # edit this file; the port's kernels build into its own `_build/`
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness, manifest

    cell = manifest.load(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = harness.execute(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t_start=T_START)
    except harness.Failed as e:
        print(f"no result: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
