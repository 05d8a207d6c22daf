"""SeamlessM4T-large-v2 [arXiv:2308.11596]: enc-dec multimodal backbone.
The 24 layers split 12 encoder + 12 decoder; the speech frontend is a STUB
(input_specs supplies precomputed frame embeddings at seq_len/4 frames)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=12,
    encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256_206, mlp="gelu",
)
SMOKE = dataclasses.replace(
    CONFIG, name="seamless-smoke", n_layers=2, encoder_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, dtype="float32")
