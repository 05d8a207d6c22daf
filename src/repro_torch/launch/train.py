"""Training launcher: the fault-tolerant driver over the deterministic
pipeline, with async checkpoints, on the visible devices, random weights
(seed 0).

    PYTHONPATH=src python -m repro_torch.launch.train            # the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5

The port of `repro/launch/train.py` with its arguments and defaults
(Qwen1.5-0.5B, 30 steps, batch 8, sequence 64, `AdamConfig(warmup=10)`,
a checkpoint every 20 steps).  As in the serving launcher the width
follows the device: the published width on the card (`get_config`), the
smoke width on the CPU (`smoke_config`); `--smoke` is accepted and
changes nothing.  On one device there is no mesh (`Ctx()`); on several
visible devices (virtual slots of one, `core.mesh.virtual_devices`) the
model and its optimizer state are sharded over the reference's
(data, model) mesh of them (`launch.mesh.model_mesh`).  Without
`--device` it wants CUDA and raises when there is none.  Without
`--ckpt` the checkpoints go to a temporary directory, removed at the
end; with it, a rerun resumes from the latest checkpoint there.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.compile import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import make_ctx, model_mesh
from repro_torch.launch.serve import device_name
from repro_torch.models import LM, Ctx, init_params
from repro_torch.models.sharding import distribute
from repro_torch.runtime.fault_tolerance import TrainDriver
from repro_torch.train.optimizer import AdamConfig
from repro_torch.train.train_step import make_train_state, train_step


def launch_params(args, device) -> LM:
    """The launcher's model: its config at the device's width, random
    weights from seed 0 on `device`."""
    cfg = (smoke_config(args.arch) if device.type == "cpu"
           else get_config(args.arch))
    return init_params(cfg, torch.Generator().manual_seed(0), device)


def make_driver(args, device, ckpt_dir: str, fail_hook=None, mesh=None,
                params: LM | None = None):
    """The launcher's state, pipeline and driver for `args` over
    `params` (default: `launch_params`), the parameters and optimizer
    state sharded over `mesh` when one is given
    (`launch.mesh.model_mesh`).  Draw the weights before a local world
    opens: its mode draws random numbers per rank."""
    params = params if params is not None else launch_params(args, device)
    cfg = params.cfg
    ctx = make_ctx(mesh) if mesh is not None else Ctx()
    if mesh is not None:
        params = LM(cfg, distribute(params.tree(), ctx))
    state = make_train_state(params, compression=args.compression)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq)
    opt_cfg = AdamConfig(warmup=10)

    def step(st, b):
        return train_step(st, b, cfg, ctx, opt_cfg, accum=args.accum)

    return cfg, TrainDriver(step_fn=step, state=state, pipeline=pipe,
                            ckpt_dir=ckpt_dir, ckpt_every=20,
                            fail_hook=fail_hook, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's flag; the width follows the "
                    "device")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device, "the training launcher")
    params = launch_params(args, device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp, \
            model_mesh(device) as mesh:
        cfg, drv = make_driver(args, device, args.ckpt or tmp, mesh=mesh,
                               params=params)
        drv.run(args.steps)
    shape = "" if mesh is None else f" over a {tuple(mesh.shape)} mesh"
    print(f"{cfg.name} on {device_name(device)}{shape}: done: "
          f"{len(drv.metrics_log)} steps, "
          f"last loss {drv.metrics_log[-1]['loss']:.4f}, "
          f"recoveries {drv.recoveries}, "
          f"stragglers {len(drv.straggler.slow_steps)}")
    return drv


if __name__ == "__main__":
    main()
