"""Assigned architecture configs (one module per arch, exact published
numbers) + reduced smoke variants.  `get_config(name)` / `smoke_config(name)`."""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen1_5_0_5b", "chatglm3_6b", "phi3_medium_14b", "h2o_danube3_4b",
    "seamless_m4t_large_v2", "deepseek_v2_236b", "granite_moe_1b_a400m",
    "internvl2_76b", "xlstm_125m", "jamba_v0_1_52b",
]

# arch id -> shapes it skips, with reason (DESIGN.md §Arch-applicability)
SKIPS: dict[str, dict[str, str]] = {
    "qwen1_5_0_5b": {"long_500k": "pure full attention (O(S^2) prefill; 500k KV infeasible)"},
    "chatglm3_6b": {"long_500k": "pure full attention"},
    "phi3_medium_14b": {"long_500k": "pure full attention"},
    "seamless_m4t_large_v2": {"long_500k": "full-attention enc-dec"},
    "deepseek_v2_236b": {"long_500k": "MLA is still full attention"},
    "granite_moe_1b_a400m": {"long_500k": "pure full attention"},
    "internvl2_76b": {"long_500k": "pure full attention"},
    # h2o_danube3 (SWA), xlstm (SSM), jamba (hybrid) run long_500k.
}


def get_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def smoke_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{name}").SMOKE


def shapes_for(name: str) -> list[str]:
    from repro_torch.models.config import SHAPES

    return [s for s in SHAPES if s not in SKIPS.get(name, {})]
