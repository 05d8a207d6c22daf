"""Serving launcher: the continuous-batching engine on the visible
devices, with random weights (seed 0).

    PYTHONPATH=src python -m repro_torch.launch.serve            # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The width follows the device: on the card the model runs at its
published width (`get_config`), on the CPU at its smoke width
(`smoke_config`).  `--smoke` is accepted as the reference launcher
accepts it (always on there) and changes nothing.  The default
architecture is Qwen1.5-0.5B.  Without `--device` the engine wants CUDA
and raises when there is none.  On several visible devices (virtual
slots of one, `core.mesh.virtual_devices`) the engine's weights and
cache are sharded over the reference's (data, model) mesh of them
(`launch.mesh.model_mesh`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.compile import resolve_device
from repro_torch.launch.mesh import make_ctx, model_mesh
from repro_torch.models import Ctx, init_params
from repro_torch.serve.batcher import Request, ServeEngine


def make_requests(cfg, n: int, max_new: int) -> list:
    """n requests with prompts of 4 to 9 tokens from `default_rng(0)` (the
    reference launcher's draw)."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab, 4 + int(rng.integers(0, 6)))
        reqs.append(Request(rid=i, prompt=prompt.astype(np.int64),
                            max_new=max_new))
    return reqs


def drain(eng: ServeEngine, reqs) -> dict:
    """Submit `reqs` and tick the engine until it is empty.  Returns the
    wall seconds, the tokens served and, for every tick, (live slots,
    slots admitted in it, ms).  A tick ends in the host copy of its next
    tokens, so its host time covers its device work."""
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    ticks = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        queued, t = len(eng.queue), time.perf_counter()
        live = eng.tick()
        ticks.append((live, queued - len(eng.queue),
                      (time.perf_counter() - t) * 1e3))
    return {"seconds": time.perf_counter() - t0, "ticks": ticks,
            "tokens": sum(len(r.out) for r in reqs)}


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "CPU"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the reference's flag; the width follows the "
                    "device")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "the serving launcher")
    cfg = (smoke_config(args.arch) if device.type == "cpu"
           else get_config(args.arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with model_mesh(device) as mesh:
        ctx = make_ctx(mesh) if mesh is not None else Ctx()
        eng = ServeEngine(params, cfg, ctx, slots=args.slots,
                          max_len=args.max_len, device=device)
        del params
        reqs = make_requests(cfg, args.requests, args.max_new)
        res = drain(eng, reqs)
    shape = "" if mesh is None else f" over a {tuple(mesh.shape)} mesh"
    print(f"{cfg.name}{shape}: {len(reqs)} requests, {res['tokens']} tokens, "
          f"{eng.ticks} ticks, {res['seconds']:.2f}s "
          f"({res['tokens'] / res['seconds']:.1f} tok/s on "
          f"{device_name(device)})")
    return reqs, eng


if __name__ == "__main__":
    main()
