"""Adam with decoupled weight decay, as functions of trees of tensors.

The port of `repro/train/optimizer.py`, with its arithmetic: the global
norm over every leaf in float32, clipping to `grad_clip`, a linear
warmup of the learning rate, bias correction, and weight decay on the
leaves of two or more dimensions only.  The blocks' tensors are stacked
over the pattern's repeats, so a block's norm scale, (reps, D), gets
decay and the unstacked `final_norm` does not, as in the reference.
The learning rate and the bias corrections `b1 ** step`, `b2 ** step`
are float32 tensors on the parameters' device, as the reference's are.
The update is functional: new tensors, the given ones unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup: int = 100


class AdamState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor           # int32 scalar on the parameters' device


def _zeros(params):
    # `zeros_like`: a DTensor's moments keep its placements
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def adam_init(params) -> AdamState:
    """Zero moments mirroring `params` (an `LM` or a tree) in float32."""
    device = leaves(params)[0].device
    return AdamState(m=_zeros(params), v=_zeros(params),
                     step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, cfg: AdamConfig):
    """Returns (new params, new state, the gradients' global norm).  New
    params are an `LM` of new tensors when `params` is one, else a tree."""
    step = state.step + 1
    stepf = step.float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cfg.lr * torch.clamp(stepf / cfg.warmup, max=1.0)
    f32 = dict(dtype=torch.float32, device=stepf.device)
    bc1 = 1 - torch.tensor(cfg.b1, **f32) ** stepf
    bc2 = 1 - torch.tensor(cfg.b2, **f32) ** stepf

    def upd(g, m, v, p):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:   # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        leaves(grads), leaves(state.m), leaves(state.v), leaves(params))]
    new_p = unflatten(params, [o[0] for o in out])
    if hasattr(params, "tree"):
        new_p = type(params)(params.cfg, new_p)
    return (new_p, AdamState(unflatten(params, [o[1] for o in out]),
                             unflatten(params, [o[2] for o in out]), step),
            gnorm)
