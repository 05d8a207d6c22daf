"""Attention: blockwise (flash-style) prefill attention, GQA, sliding
window, decode against a KV cache, and MLA's absorbed decode scores.

The port of `repro/models/attention.py` in plain torch.  The reference
computes every function here in plain JAX (no Pallas kernel), so these
are plain torch too: a hand kernel for decode attention waits for a cell
that can measure it (ROADMAP Queue 2).  Scores and the probability-value
products accumulate in float32 (the reference's
`preferred_element_type=jnp.float32`): the operands are upcast, so a
bf16 product is exact and its sum float32.  Masked scores are `NEG`
(-1e30), and the blockwise normaliser is clamped at 1e-20, as in the
reference.

`decode_attention` and `mla_decode_scores` take the valid length as an
int or as a (B,) tensor: one length a row, so each row of a batch
attends over its own prefix.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _f32(t):
    return t.float()


def _mask(sq, sk, causal, window, device, qoff=0, koff=0):
    qpos = qoff + torch.arange(sq, device=device)
    kpos = koff + torch.arange(sk, device=device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    dpos = qpos[:, None] - kpos[None, :]
    if causal:
        mask &= dpos >= 0
    if window is not None:
        mask &= dpos < window
    return mask


def naive_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    scale: float | None = None):
    """Reference S x S attention.  q: (B,S,H,dk), k: (B,Sk,Hkv,dk),
    v: (B,Sk,Hkv,dv) -> (B,S,H,dv)."""
    b, sq, h, dk = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else dk ** -0.5
    qg = q.reshape(b, sq, hkv, g, dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", _f32(qg), _f32(k)) * scale
    mask = _mask(sq, k.shape[1], causal, window, q.device)
    s = torch.where(mask[None, None, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", _f32(p.to(v.dtype)), _f32(v))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _fit(block, s):
    # largest divisor of s not exceeding the requested block size
    # (VLM cells prepend patches: S = 4096 + 256 = 4352 = 256·17)
    block = min(block, s)
    while s % block:
        block -= 1
    return block


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        q_block: int = 256, kv_block: int = 512,
                        scale: float | None = None,
                        unroll: bool = False):
    """q: (B,S,H,dk), k: (B,Sk,Hkv,dk), v: (B,Sk,Hkv,dv) -> (B,S,H,dv).

    Online softmax over (q block, kv block) tiles, in the reference's
    order: the outer loop over query blocks, the inner over KV blocks."""
    if unroll:
        return naive_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    b, sq, h, dk = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = scale if scale is not None else dk ** -0.5
    q_block = _fit(q_block, sq)
    kv_block = _fit(kv_block, sk)
    nq, nk = sq // q_block, sk // kv_block

    qb = _f32(q.reshape(b, nq, q_block, hkv, g, dk))
    kb = _f32(k.reshape(b, nk, kv_block, hkv, dk))
    vb = v.reshape(b, nk, kv_block, hkv, dv)
    outs = []
    for qi in range(nq):
        qt = qb[:, qi]                                    # (B,bq,Hkv,G,dk)
        m = torch.full((b, hkv, g, q_block), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, q_block), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, g, q_block, dv), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            kt, vt = kb[:, ki], vb[:, ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kt) * scale
            mask = _mask(q_block, kv_block, causal, window, q.device,
                         qi * q_block, ki * kv_block)
            s = torch.where(mask[None, None, None], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))      # (B,Hkv,G,bq)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", _f32(p.to(vt.dtype)),
                              _f32(vt))
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-20))
    out = torch.stack(outs)                               # (nq,B,Hkv,G,bq,dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def _valid(cache_len, smax, batch, device):
    """(B, Smax) positions below each row's valid length."""
    pos = torch.arange(smax, device=device)
    lens = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    return (pos[None, :] < lens).expand(batch, smax), pos, lens


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: int | None = None, scale: float | None = None):
    """Single-token attention against a cache.

    q: (B,H,dk); k_cache: (B,Smax,Hkv,dk); v_cache: (B,Smax,Hkv,dv);
    cache_len: int or (B,) tensor, the valid prefix length (the new token
    included) of every row or of each row.
    """
    b, h, dk = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else dk ** -0.5
    qg = q.reshape(b, hkv, g, dk)
    s = torch.einsum("bhgd,bkhd->bhgk", _f32(qg), _f32(k_cache)) * scale
    valid, pos, lens = _valid(cache_len, k_cache.shape[1], b, q.device)
    if window is not None:
        valid = valid & (pos[None, :] >= lens - window)
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(v_cache.dtype)),
                       _f32(v_cache))
    return out.reshape(b, h, -1).to(q.dtype)


def mla_decode_scores(q_nope_abs, q_pe, ckv_cache, kpe_cache, cache_len,
                      scale: float):
    """Absorbed MLA decode: score against the *compressed* cache.

    q_nope_abs: (B,H,kv_lora) — q_nope @ w_uk absorbed
    q_pe: (B,H,rope_dim); ckv_cache: (B,Smax,kv_lora); kpe_cache:(B,Smax,rd);
    cache_len: int or (B,) tensor.  Returns attention weights (B,H,Smax).
    """
    s = (torch.einsum("bhl,bkl->bhk", _f32(q_nope_abs), _f32(ckv_cache))
         + torch.einsum("bhr,bkr->bhk", _f32(q_pe), _f32(kpe_cache))) * scale
    valid, _, _ = _valid(cache_len, ckv_cache.shape[1], s.shape[0],
                         s.device)
    s = torch.where(valid[:, None, :], s, NEG)
    return torch.softmax(s, dim=-1)
