"""H2O-Danube3-4B [arXiv:2401.16818]: llama+mistral mix, sliding-window
attention — the SWA bound makes the long_500k decode cell feasible."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10_240, vocab=32_000,
    attn="swa", window=4096,
)
SMOKE = dataclasses.replace(
    CONFIG, name="danube-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, window=8, dtype="float32")
