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
- `train_state_from_reference(state, cfg, device)`: the reference's
  `TrainState` as numpy (`jax.tree.map(np.asarray, state)`: params,
  `opt.m`, `opt.v`, `opt.step`, `ef`) as the port's, bit for bit.
  `train_state_to_reference(state)` is its inverse: the port's
  `TrainState` and `AdamState` of numpy leaves, whose fields and key
  paths are the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compile import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, init_tree
from repro_torch.models.tree import tree_map


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    return LM(cfg, init_tree(cfg, generator,
                             resolve_device(device, "init_params")))


def _tensors(tree, device):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(
        device), tree)


def _arrays(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def from_reference(params, cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, _tensors(params, resolve_device(device, "from_reference")))


def to_reference(model: LM):
    return _arrays(model.tree())


def train_state_from_reference(state, cfg: ModelConfig, device=None):
    from repro_torch.train.optimizer import AdamState
    from repro_torch.train.train_step import TrainState

    device = resolve_device(device, "train_state_from_reference")
    ef = None if state.ef is None else _tensors(state.ef, device)
    return TrainState(
        params=LM(cfg, _tensors(state.params, device)),
        opt=AdamState(m=_tensors(state.opt.m, device),
                      v=_tensors(state.opt.v, device),
                      step=_tensors(state.opt.step, device)),
        ef=ef)


def train_state_to_reference(state):
    from repro_torch.train.optimizer import AdamState
    from repro_torch.train.train_step import TrainState

    return TrainState(
        params=to_reference(state.params),
        opt=AdamState(m=_arrays(state.opt.m), v=_arrays(state.opt.v),
                      step=_arrays(state.opt.step)),
        ef=None if state.ef is None else _arrays(state.ef))
