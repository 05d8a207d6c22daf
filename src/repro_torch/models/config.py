"""Model configuration for the assigned architecture pool.

One frozen dataclass covers all 10 families; `repro_torch/configs/<id>.py`
instantiates the exact published numbers and a reduced smoke variant.
A copy of the reference's `repro/models/config.py`, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # ---- attention ----------------------------------------------------------
    attn: str = "full"           # full | swa
    window: int = 4096           # swa window
    rope: str = "default"        # default | half | none  (half = 2d/partial)
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    # ---- mlp ------------------------------------------------------------------
    mlp: str = "swiglu"          # swiglu | gelu
    # ---- MoE -------------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    topk: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert FFN width
    moe_every: int = 1           # MoE layer period (jamba: 2)
    capacity_factor: float = 2.0
    # ---- MLA (deepseek-v2) -------------------------------------------------------
    mla: bool = False
    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64           # decoupled rope key dim
    v_head_dim: int = 128
    # ---- SSM / hybrid / xLSTM -------------------------------------------------
    # per-super-block layer pattern, tiled to n_layers.  entries:
    #   'attn' | 'mamba' | 'slstm' | 'mlstm'
    pattern: tuple[str, ...] = ("attn",)
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    # ---- encoder-decoder --------------------------------------------------------
    encoder_layers: int = 0      # >0 => enc-dec; decoder = n_layers
    # ---- vlm ------------------------------------------------------------------
    n_patches: int = 0           # stub patch embeddings prepended
    # ---- misc -----------------------------------------------------------------
    tie_embeddings: bool = False
    dtype: str = "bfloat16"      # compute dtype
    param_dtype: str = "float32"
    # unroll the layer stack into straight-line HLO instead of lax.scan —
    # used by the dry-run cost probes (HloCostAnalysis counts while-loop
    # bodies once) and available as a compile-time/runtime trade-off knob.
    unroll: bool = False
    # attention implementation when unrolled: 'naive' exposes exact S×S
    # FLOPs to the cost analyzer; 'blockwise' keeps flash semantics so the
    # probe's byte counts reflect streamed (non-materialized) attention.
    attn_impl: str = "naive"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind, tiling `pattern` to n_layers."""
        out = []
        i = 0
        while len(out) < self.n_layers:
            out.append(self.pattern[i % len(self.pattern)])
            i += 1
        return out

    def is_moe_layer(self, i: int) -> bool:
        return self.moe and (i % self.moe_every == self.moe_every - 1)

    def active_params_note(self) -> str:
        return "MoE: roofline uses 6*N_active*D" if self.moe else "dense"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
