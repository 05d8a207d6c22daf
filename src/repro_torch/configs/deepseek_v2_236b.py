"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA (kv_lora=512, q_lora=1536,
decoupled rope 64, v=128) + MoE (2 shared + 160 routed, top-6, expert
d_ff=1536).  All layers MoE (the real model's first dense layer is folded
into the uniform scan — noted in DESIGN.md)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=0, vocab=102_400,
    head_dim=128, pattern=("mla",), mla=True, kv_lora=512, q_lora=1536,
    rope_dim=64, v_head_dim=128,
    moe=True, n_experts=160, topk=6, n_shared_experts=2, moe_d_ff=1536,
)
SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, kv_lora=32, q_lora=48, rope_dim=8,
    v_head_dim=16, n_experts=4, topk=2, n_shared_experts=1, moe_d_ff=32,
    vocab=256, dtype="float32")
