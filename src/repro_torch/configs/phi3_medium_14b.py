"""Phi-3-medium-14B [arXiv:2404.14219]: dense, GQA kv=10, RoPE, SwiGLU."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17_920, vocab=100_352,
)
SMOKE = dataclasses.replace(
    CONFIG, name="phi3-smoke", n_layers=2, d_model=80, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab=256, dtype="float32")
