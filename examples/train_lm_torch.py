"""End-to-end training on the PyTorch port: train a small Qwen-family
model on the synthetic pipeline with the fault-tolerant driver and async
checkpointing (the port's counterpart of `examples/train_lm.py`).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200             # the card
    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --device cpu

It trains the reduced config of the family (at least 2 layers) from
random weights (seed 0) on the structured pipeline, and prints the loss
curve, which should fall from about ln(vocab).  Without `--device` it
runs on the CUDA card and raises when there is none.
"""
import argparse
import dataclasses
import math
import tempfile

import torch

from repro_torch.configs import smoke_config
from repro_torch.core.compile import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import Ctx, init_params
from repro_torch.runtime.fault_tolerance import TrainDriver
from repro_torch.train.optimizer import AdamConfig
from repro_torch.train.train_step import make_train_state, train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--compression", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "train_lm_torch")
    cfg = smoke_config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=max(cfg.n_layers, 2))
    ctx = Ctx()
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M on {device}")

    state = make_train_state(params, compression=args.compression)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
                         structured=True)
    opt_cfg = AdamConfig(lr=3e-4, warmup=20)

    def stepper(st, b):
        return train_step(st, b, cfg, ctx, opt_cfg)

    with tempfile.TemporaryDirectory(prefix="train_lm_torch_") as tmp:
        drv = TrainDriver(step_fn=stepper, state=state, pipeline=pipe,
                          ckpt_dir=args.ckpt or tmp, ckpt_every=50,
                          device=device)
        drv.run(args.steps)
    log = drv.metrics_log
    for m in log[:: max(1, len(log) // 10)]:
        print(f"step {m['step']:>5}  loss {m['loss']:.4f}  "
              f"{m['dt'] * 1e3:.0f} ms")
    print(f"final loss {log[-1]['loss']:.4f} "
          f"(init ~{math.log(cfg.vocab):.2f}); stragglers: "
          f"{len(drv.straggler.slow_steps)}")
    return log


if __name__ == "__main__":
    main()
