"""Granite-3.0-1B-A400M [hf:ibm-granite]: 32 experts top-8, expert d_ff=512."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=0, vocab=49_155,
    moe=True, n_experts=32, topk=8, moe_d_ff=512,
)
SMOKE = dataclasses.replace(
    CONFIG, name="granite-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, n_experts=4, topk=2, moe_d_ff=32, vocab=256,
    dtype="float32")
