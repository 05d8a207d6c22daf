"""Weights of the port's models: random ones, and the reference's.

- `init_params(cfg, generator, device)`: random weights with the
  reference's shapes, dtypes and scales.  JAX's random stream cannot be
  reproduced in torch, so the values differ from the reference's
  `init_params(PRNGKey(...))`; one generator seed gives the same weights
  on every device (the draws happen on the generator's device).
  Without `device` the weights go to the CUDA card (and a missing card
  raises); the CPU is asked for with `device="cpu"`.
- `from_reference(params, cfg, device)`: the reference's parameter tree
  (dicts and tuples of numpy arrays, `jax.tree.map(np.asarray, params)`)
  as the port's `LM`.  `to_reference(model)` is its inverse: the same
  tree of numpy arrays, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compile import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, init_tree


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    return LM(cfg, init_tree(cfg, generator,
                             resolve_device(device, "init_params")))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def from_reference(params, cfg: ModelConfig, device=None) -> LM:
    device = resolve_device(device, "from_reference")
    return LM(cfg, _map(params, lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(device)))


def to_reference(model: LM):
    return _map(model.tree(), lambda t: t.detach().cpu().numpy())
