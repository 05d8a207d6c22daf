"""Jamba-v0.1 52B [arXiv:2403.19887]: Mamba+attention 7:1 interleave
(attention at position 4 of every 8-layer block), MoE every 2 layers
(16 experts top-2, expert d_ff = 14336)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14_336, vocab=65_536,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba"),
    moe=True, n_experts=16, topk=2, moe_d_ff=14_336, moe_every=2,
)
SMOKE = dataclasses.replace(
    CONFIG, name="jamba-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, n_experts=4, topk=2, moe_d_ff=64, vocab=256,
    dtype="float32")
