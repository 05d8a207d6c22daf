"""The train step: loss, gradients, optional gradient compression, Adam.

The port of `repro/train/train_step.py`.  The loss drops
the patch positions (`logits[:, -s:]`), takes a float32 logsumexp and
honours `loss_mask`; the labels are gathered with an int64 index
(`torch.gather` wants one; the pipeline's tokens are int32).  Over a
mesh the logits come out vocabulary-sharded over `model`: the gather
reads them whole (an all-gather of the vocabulary axis, what GSPMD
does for it), while `REPRO_LOSS_MODE=onehot` takes the label as a
one-hot contraction, which sums each shard's part instead.

With `accum > 1` the batch splits along its leading axis into `accum`
microbatches, as the reference's `reshape(accum, b // accum, ...)`
does; their float32 gradients are summed in order, then divided by
`accum`, and the loss is the microbatches' mean.  The step is
functional: it returns a new state and leaves the given one unchanged,
so a step that raises leaves the state as it was (the fault-tolerant
driver's recovery rests on that).
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import Ctx, P, batch_entry
from repro_torch.models.transformer import LM, forward_train
from repro_torch.train.grad_compression import compress_grads, ef_init
from repro_torch.train.optimizer import (AdamConfig, AdamState, adam_init,
                                         adam_update)
from repro_torch.models.tree import leaves, unflatten


class TrainState(NamedTuple):
    params: Any                  # an LM of float32 masters
    opt: AdamState
    ef: Optional[Any] = None     # error-feedback buffers (compression on)


def make_train_state(params: LM, *, compression: bool = False) -> TrainState:
    return TrainState(params=params, opt=adam_init(params),
                      ef=ef_init(params) if compression else None)


def loss_fn(params: LM, batch, cfg: ModelConfig, ctx: Ctx):
    logits = forward_train(params, batch, cfg, ctx)
    targets = ctx.constraint(
        torch.as_tensor(batch["targets"], device=logits.device),
        P(batch_entry(ctx, logits.shape[0]), None))
    s = targets.shape[1]
    logits = logits[:, -s:].float()               # drop patch positions
    lse = torch.logsumexp(logits, dim=-1)
    if os.environ.get("REPRO_LOSS_MODE", "gather") == "onehot":
        # the label lookup as a one-hot contraction: partitions cleanly
        # over a vocabulary sharded over `model` (no cross-shard gather)
        onehot = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
        lab = torch.sum(logits * onehot, dim=-1)
    else:
        # a gather across vocabulary shards needs the whole row first
        whole = ctx.constraint(logits, P(batch_entry(ctx, logits.shape[0]),
                                         None, None))
        lab = torch.gather(whole, -1, targets.long().unsqueeze(-1)
                           ).squeeze(-1)
    ce = lse - lab
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
        ce = ce * mask
        return ce.sum() / torch.clamp(mask.sum(), min=1.0)
    return ce.mean()


def value_and_grad(params: LM, batch, cfg: ModelConfig, ctx: Ctx):
    """The loss (detached) and its gradients, a tree of `params`'
    structure in the masters' dtype; a leaf the loss does not reach gets
    zeros, as in the reference."""
    flat = leaves(params)
    loss = loss_fn(params, batch, cfg, ctx)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


def train_step(state: TrainState, batch, cfg: ModelConfig, ctx: Ctx,
               opt_cfg: AdamConfig = AdamConfig(), accum: int = 1):
    """Returns (new state, {"loss", "grad_norm", "step"}), each metric a
    tensor on the parameters' device."""
    device = state.params.embed.device
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    if accum == 1:
        loss, grads = value_and_grad(state.params, batch, cfg, ctx)
    else:
        b = batch["tokens"].shape[0]
        if b % accum:
            raise ValueError(f"a batch of {b} does not split into {accum} "
                             "microbatches")
        gsum, lsum = None, 0.0
        for k in range(accum):
            mb = {n: x.reshape(accum, b // accum, *x.shape[1:])[k]
                  for n, x in batch.items()}
            loss_k, g = value_and_grad(state.params, mb, cfg, ctx)
            g = [x.float() for x in leaves(g)]
            gsum = g if gsum is None else [a + x for a, x in zip(gsum, g)]
            lsum = lsum + loss_k
        grads = unflatten(state.params, [g / accum for g in gsum])
        loss = lsum / accum

    ef = state.ef
    if ef is not None:
        grads, ef = compress_grads(grads, ef)

    new_params, new_opt, gnorm = adam_update(grads, state.opt, state.params,
                                             opt_cfg)
    metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt.step}
    return TrainState(new_params, new_opt, ef), metrics
