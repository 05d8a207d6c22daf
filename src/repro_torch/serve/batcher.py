"""Continuous-batching request server for the language models
(slot-based, MaxText/vLLM style): the port of `repro/serve/batcher.py`
with its slot semantics repaired.

A fixed pool of B slots shares one cache; each slot holds one request
at its own position.  Admission fills free slots from the queue, and
every engine tick decodes one token for all slots in one batched
`decode_step`.  A finished slot frees at once.

Slots are independent, unlike the reference's engine:

- admission resets the slot's cache rows to `init_cache`'s values, runs
  the prompt through those rows alone (batch 1, one `decode_step` a
  token) and writes back only them, so no other slot's rows or state
  move (the reference runs the prompt through the whole batch, token 0
  in every other slot, which overwrites their KV rows at 0..P-1 and
  advances their recurrent state);
- each tick decodes every slot at its own position (a (B,) `pos`; the
  reference decodes all at the first live slot's).

Up to 8 slots, every request gets the tokens it gets served alone: a
decode batch of at most 8 tokens fits the MoE capacity (at least 8), so
no token is dropped.  The next token is the first maximum of the logits
(`np.argmax`).  The engine is synchronous and tick-driven; a front end
wraps `tick()` in its own loop.  A tick runs without autograd, so no
step records a graph of the parameters it reads.  Given a context with a
mesh (`Ctx(mesh=...)`), the weights and the cache are sharded over it
(`param_specs`, `cache_spec`); an admission writes its slot's rows into
the gathered cache and splits it again.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.compile import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (Ctx, cache_spec, distribute,
                                         distribute_cache, gather, place)
from repro_torch.models.transformer import (LM, cast_params, decode_step,
                                            init_cache)

S_ENC = 8            # encoder positions of an enc-dec slot's cross cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) ints
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # tokens to emit in place of the argmax, in order: a replay of another
    # run's stream, so two runs' logits can be compared step for step
    force: Optional[list] = None
    # when set, the float32 logits (V,) that chose each token of `out`
    logits: Optional[list] = None


def first_max(logits: torch.Tensor) -> np.ndarray:
    """Each row's index of its first maximum, NaN counting as the
    largest (`np.argmax`), as a host array."""
    logits = gather(logits)
    top = logits.amax(dim=-1, keepdim=True)
    hit = (logits == top) | torch.isnan(logits)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(hit, cols, logits.shape[-1]).amin(dim=-1).cpu().numpy()


class ServeEngine:
    def __init__(self, params: LM, cfg: ModelConfig, ctx: Ctx | None = None,
                 *, slots: int, max_len: int,
                 stop_token: Optional[int] = None, device=None):
        self.device = resolve_device(device, "ServeEngine")
        self.ctx = ctx or Ctx()
        # the compute-dtype copy on the device, held for every step, and
        # sharded over the context's mesh when it has one
        self.params = cast_params(params, cfg, self.device)
        if self.ctx.mesh is not None:
            self.params = LM(cfg, distribute(self.params.tree(), self.ctx))
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.stop_token = stop_token
        self.s_enc = S_ENC if cfg.encoder_layers else 0
        self.cache = distribute_cache(
            init_cache(cfg, slots, max_len, self.s_enc, self.device), slots,
            self.ctx)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, dtype=np.int64)
        self.slot_limit = np.zeros(slots, dtype=np.int64)
        self.queue: list[Request] = []
        self.ticks = 0

    # -- client API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if not 0 < len(req.prompt) < self.max_len:
            raise ValueError(f"request {req.rid}: a prompt of "
                             f"{len(req.prompt)} tokens does not fit "
                             f"max_len {self.max_len}")
        self.queue.append(req)

    def _emit(self, req: Request, logits: torch.Tensor, nxt: int) -> int:
        logits = gather(logits)
        if req.logits is not None:
            req.logits.append(logits.float().cpu())
        if req.force is not None:
            nxt = int(req.force[len(req.out)])
        req.out.append(nxt)
        return nxt

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            # the slot's own rows, clean, at batch 1
            rows = init_cache(self.cfg, 1, self.max_len, self.s_enc,
                              self.device)
            for i, tok in enumerate(req.prompt):
                logits, rows = decode_step(
                    self.params, torch.tensor([int(tok)]), rows, i,
                    self.cfg, self.ctx)
            self._write_slot(s, rows)
            self.slot_req[s] = req
            self.slot_pos[s] = len(req.prompt)
            self.slot_limit[s] = len(req.prompt) + req.max_new
            self._emit(req, logits[0], int(first_max(logits)[0]))

    def _write_slot(self, s: int, rows) -> None:
        """Slot `s`'s rows of the cache set to `rows` (a batch-1 cache).
        A sharded cache is gathered, written and split again."""
        for c, r in zip(self.cache, rows):
            for k in c:
                if self.ctx.mesh is None:
                    c[k][:, s] = r[k][:, 0]
                    continue
                whole = gather(c[k])
                whole[:, s] = gather(r[k])[:, 0]
                c[k] = place(whole, self.ctx.mesh, cache_spec(
                    tuple(whole.shape), self.slots, self.ctx))

    # -- engine tick ------------------------------------------------------------
    @torch.no_grad()
    def tick(self) -> int:
        """Admit + decode one token for all live slots.  Returns #live."""
        self._admit()
        live = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not live:
            return 0
        toks = np.zeros(self.slots, dtype=np.int64)
        pos = np.zeros(self.slots, dtype=np.int64)   # a free slot: row 0
        for s in live:
            toks[s] = self.slot_req[s].out[-1]
            pos[s] = self.slot_pos[s]
        logits, self.cache = decode_step(
            self.params, torch.from_numpy(toks), self.cache,
            torch.from_numpy(pos), self.cfg, self.ctx)
        nxt_all = first_max(logits)
        for s in live:
            req = self.slot_req[s]
            nxt = self._emit(req, logits[s], int(nxt_all[s]))
            self.slot_pos[s] += 1
            if (self.slot_pos[s] >= self.slot_limit[s]
                    or nxt == self.stop_token
                    or self.slot_pos[s] >= self.max_len - 1):
                req.done = True
                self.slot_req[s] = None
        self.ticks += 1
        return len(live)

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and self.ticks < max_ticks:
            self.tick()
