"""Int8 gradient compression with error feedback.

The port of `repro/train/grad_compression.py`: per-leaf symmetric int8
quantization of the gradient, with a persistent error-feedback buffer
(the residual added back before the next quantization).  In a
deployment over several hosts it wraps the slow leg of the gradient
all-reduce; on one device the quantize-dequantize round trip is the
same arithmetic.  The scale is `max(max|g|, 1e-12) / 127`, and
`torch.round` rounds half to even, as `jnp.round` does.
"""
from __future__ import annotations

import torch

from repro_torch.models.tree import leaves, tree_map, unflatten


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _q8(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q, scale):
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads, ef_buf):
    """Returns (dequantized grads as seen after the compressed exchange,
    new error-feedback buffers), trees of `grads`' structure."""

    def leaf(g, e):
        g32 = g.float() + e
        q, s = _q8(g32)
        dq = _dq8(q, s)
        return dq.to(g.dtype), g32 - dq

    out = [leaf(g, e) for g, e in zip(leaves(grads), leaves(ef_buf))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
