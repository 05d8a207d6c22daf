"""ChatGLM3-6B [arXiv:2406.12793]: dense, GQA kv=2, 2D (half) RoPE."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13_696, vocab=65_024,
    rope="half", qkv_bias=True,
)
SMOKE = dataclasses.replace(
    CONFIG, name="chatglm-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, dtype="float32")
