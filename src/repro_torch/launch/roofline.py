"""Roofline terms and analytic model counts, for one NVIDIA H100.

The port of `repro/launch/roofline.py` (which imports only `re`), with
its imports renamed and its machine constants the H100's:

  compute    = FLOPs      / (chips · 989 TFLOP/s bf16 dense)
  memory     = HBM bytes  / (chips · 3.35 TB/s HBM3)
  collective = coll_bytes / (chips · 450 GB/s NVLink, one direction)

all three from NVIDIA's H100 SXM data sheet (dense rates without
sparsity, at the full 700 W power limit).  `param_count` and
`model_flops` (6·N·D for a train step, N the active parameters) set the
bound of the train step.  `collective_bytes` parses XLA's HLO text: it
sums operand bytes of all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute (the -start variants counted, -done
skipped); the port produces no HLO, and the parser is kept for the
reference's dry-run artifacts.
"""
from __future__ import annotations

import re

PEAK_FLOPS = 989e12        # bf16 dense / H100 SXM (data sheet)
HBM_BW = 3.35e12           # bytes/s HBM3 / H100 SXM (data sheet)
NVLINK_BW = 450e9          # bytes/s a direction / H100 SXM (data sheet)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "token": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_DEF_RE = re.compile(r"^\s*(%?[\w.\-]+)\s*=\s*(.*)$")
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Sum of operand bytes per collective kind, from partitioned HLO."""
    sizes: dict[str, int] = {}
    pending: list[tuple[str, list[str]]] = []
    for line in hlo_text.splitlines():
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, rest = m.group(1).lstrip("%"), m.group(2)
        # result type = prefix of `rest` up to the op name
        op_m = re.search(r"\)?\s*([a-z][\w\-]*)\(", rest)
        type_part = rest[: op_m.start()] if op_m else rest
        sizes[name] = _type_bytes(type_part)
        if not op_m:
            continue
        op = op_m.group(1)
        kind = next((c for c in _COLLECTIVES if op == c or op == c + "-start"),
                    None)
        if kind is None:
            continue
        args = rest[op_m.end():rest.rfind(")")]
        operands = re.findall(r"%?([\w.\-]+)", args)
        pending.append((kind, operands))
    out: dict[str, int] = {}
    for kind, operands in pending:
        b = sum(sizes.get(o, 0) for o in operands)
        out[kind] = out.get(kind, 0) + b
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) useful training FLOPs; for
    inference cells: 2·N·D per generated/prefilled token."""
    n = param_count(cfg, active_only=True)
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d_tokens


def param_count(cfg, active_only: bool = False) -> float:
    """Analytic parameter count from the config."""
    d, v = cfg.d_model, cfg.vocab
    total = v * d                                     # embed
    if not cfg.tie_embeddings:
        total += d * v
    kinds = cfg.layer_kinds()
    for i, kind in enumerate(kinds):
        if kind == "attn":
            hd = cfg.hd
            total += d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
                + cfg.n_heads * hd * d
        elif kind == "mla":
            nope, rd, dv = cfg.hd, cfg.rope_dim, cfg.v_head_dim
            total += d * cfg.q_lora + cfg.q_lora * cfg.n_heads * (nope + rd)
            total += d * (cfg.kv_lora + rd)
            total += cfg.kv_lora * cfg.n_heads * (nope + dv)
            total += cfg.n_heads * dv * d
        elif kind == "mamba":
            di = cfg.ssm_expand * d
            rank = max(1, d // 16)
            total += d * 2 * di + di * (rank + 2 * cfg.ssm_state) \
                + rank * di + di * d
        elif kind == "mlstm":
            total += 5 * d * d + 2 * d * cfg.n_heads
        elif kind == "slstm":
            total += 9 * d * d
        if kind in ("attn", "mla", "mamba"):
            if cfg.is_moe_layer(i):
                f = cfg.moe_d_ff or cfg.d_ff
                e_count = (cfg.topk if active_only else cfg.n_experts)
                total += 3 * d * f * e_count + d * cfg.n_experts  # router
                total += 3 * d * f * cfg.n_shared_experts
            elif cfg.d_ff > 0:
                mult = 3 if cfg.mlp == "swiglu" else 2
                total += mult * d * cfg.d_ff
    if cfg.encoder_layers:
        hd = cfg.hd
        per = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
               + cfg.n_heads * hd * d)
        mult = 3 if cfg.mlp == "swiglu" else 2
        per += mult * d * cfg.d_ff
        total += cfg.encoder_layers * per
        # decoder cross-attention
        total += len(kinds) * (d * cfg.n_heads * hd
                               + 2 * d * cfg.n_kv_heads * hd
                               + cfg.n_heads * hd * d)
    return float(total)


def flash_bytes(cfg, shape, chips: int) -> float:
    """Analytic one-pass q/k/v/out HBM bytes for streamed (flash) attention,
    added to the blockwise-probe byte counts (whose attention loops the
    analyzer counts once).  Train cells pay the pass ~3× (fwd + bwd reads +
    dgrads); prefill/encode ~1×."""
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k in ("attn", "mla"))
    s = shape.seq_len
    b = shape.global_batch
    dt = 2  # bf16
    if cfg.mla:
        dk, dv, hq, hkv = cfg.hd + cfg.rope_dim, cfg.v_head_dim, \
            cfg.n_heads, cfg.n_heads
    else:
        dk = dv = cfg.hd
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
    per_layer = (b * s * hq * dk + b * s * hkv * (dk + dv)
                 + b * s * hq * dv) * dt
    total = n_attn * per_layer
    if cfg.encoder_layers:
        se = max(s // 4, 8)
        total += cfg.encoder_layers * (
            (b * se * hq * dk + b * se * hkv * (dk + dv)
             + b * se * hq * dv) * dt)
        # decoder cross attention reads encoder K/V per layer
        total += len(kinds) * (b * se * hkv * (dk + dv)) * dt
    mult = 3.0 if shape.kind == "train" else 1.0
    return mult * total / chips


def slstm_correction_flops(cfg, shape, chips: int) -> float:
    """sLSTM's recurrent R-matmul runs in an inherently sequential
    per-token while loop, which HloCostAnalysis counts once; add the
    analytic (trip_count − 1) × body cost.  Applied per device."""
    n_slstm = sum(1 for k in cfg.layer_kinds() if k == "slstm")
    if n_slstm == 0:
        return 0.0
    s = shape.seq_len if shape.kind != "decode" else 1
    if s <= 1:
        return 0.0
    b = shape.global_batch
    body = 2.0 * b * cfg.d_model * 4 * cfg.d_model      # h @ R per step
    return n_slstm * (s - 1) * body / chips


def analytic_hbm_bytes(cfg, shape, chips: int) -> float:
    """Napkin HBM-traffic model per device (what the memory term would be
    with perfect fusion — `bytes accessed` counts pre-fusion dataflow and
    overstates traffic by 1–2 orders of magnitude).  Components:
      train:   weights 2 passes bf16 (fwd+bwd) + optimizer f32 r/w (m,v,p),
               remat residuals ~3 passes, logits ~3 passes, flash attention
               one-pass q/k/v/out, MoE token gather/scatter ~4 passes;
      prefill: weights 1 pass + activations 2 + cache write + attention;
      decode:  weights 1 pass + full cache read + tiny activations.
    """
    n_total = param_count(cfg)
    b, s = shape.global_batch, shape.seq_len
    d, v = cfg.d_model, cfg.vocab
    toks = b * (s if shape.kind != "decode" else 1)
    bytes_ = 0.0
    if shape.kind == "train":
        bytes_ += n_total * (2 * 2 + 12 + 4)          # w fwd+bwd, adam, grads
        bytes_ += 3 * cfg.n_layers * toks * d * 2     # remat residuals
        bytes_ += 3 * toks * v * 2                    # logits
        bytes_ += flash_bytes(cfg, shape, 1)
        if cfg.moe:
            bytes_ += 4 * toks * cfg.topk * d * 4
    elif shape.kind == "prefill":
        bytes_ += n_total * 2
        bytes_ += 2 * cfg.n_layers * toks * d * 2
        bytes_ += flash_bytes(cfg, shape, 1)
        bytes_ += toks * cfg.n_kv_heads * cfg.hd * 2 * cfg.n_layers  # cache
    else:  # decode
        bytes_ += param_count(cfg, active_only=True) * 2
        kinds = cfg.layer_kinds()
        for k in kinds:
            if k == "attn":
                bytes_ += b * s * cfg.n_kv_heads * cfg.hd * 2 * 2
            elif k == "mla":
                bytes_ += b * s * (cfg.kv_lora + cfg.rope_dim) * 2
            elif k == "mamba":
                bytes_ += b * cfg.ssm_expand * d * cfg.ssm_state * 4
            elif k in ("mlstm", "slstm"):
                bytes_ += b * d * (d // max(cfg.n_heads, 1) + 4) * 4
    return bytes_ / chips


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, chips: int) -> dict:
    compute = flops_per_dev / PEAK_FLOPS
    memory = bytes_per_dev / HBM_BW
    collective = coll_bytes_per_dev / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k] if k.endswith("_s") else -1)
    terms["bound_s"] = max(compute, memory, collective)
    terms["roofline_fraction"] = compute / max(terms["bound_s"], 1e-30)
    return terms
