"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: dense, QKV bias, tied embeddings."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=2816, vocab=151_936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)
SMOKE = dataclasses.replace(
    CONFIG, name="qwen-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, dtype="float32")
