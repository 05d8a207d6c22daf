"""Serving example on the PyTorch port: the continuous-batching engine on
a reduced-config model (the counterpart of `examples/serve_lm.py`).

    PYTHONPATH=src python examples/serve_lm_torch.py --requests 6 --slots 2               # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --requests 6 --slots 2 --device cpu

The weights are random (`torch.Generator().manual_seed(0)`), so the
tokens are noise; the point is the engine's schedule.  Without
`--device` the engine runs on the CUDA card and raises when there is
none.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.compile import resolve_device
from repro_torch.models import Ctx, init_params
from repro_torch.serve.batcher import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "serve_lm_torch")

    cfg = smoke_config(args.arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(params, cfg, Ctx(), slots=args.slots, max_len=64,
                      device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, 4 + i % 3).astype(
                        np.int64),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    for r in reqs:
        print(f"req {r.rid}: prompt={r.prompt.tolist()} -> {r.out}")
    print(f"engine ticks: {eng.ticks} (continuous batching over "
          f"{args.slots} slots on {device})")
    return reqs, eng


if __name__ == "__main__":
    main()
