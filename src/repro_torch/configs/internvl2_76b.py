"""InternVL2-76B [arXiv:2404.16821]: InternLM2-76B language backbone; the
InternViT frontend is a STUB (input_specs supplies 256 precomputed patch
embeddings prepended to the text sequence)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28_672, vocab=128_256, n_patches=256,
)
SMOKE = dataclasses.replace(
    CONFIG, name="internvl-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, n_patches=8, dtype="float32")
