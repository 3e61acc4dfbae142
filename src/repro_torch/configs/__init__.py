"""Assigned architecture registry.

Each module defines ``CONFIG`` (the exact published configuration) — the
registry maps ``--arch <id>`` to it.  ``paper_models`` holds the four model
configs the paper itself evaluates (used by the sizing benchmarks; never
compiled at full scale).
"""
from repro_torch.config import ModelConfig

from repro_torch.configs.llama3_2_1b import CONFIG as llama3_2_1b
from repro_torch.configs.phi3_medium_14b import CONFIG as phi3_medium_14b
from repro_torch.configs.qwen2_5_14b import CONFIG as qwen2_5_14b
from repro_torch.configs.glm4_9b import CONFIG as glm4_9b
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from repro_torch.configs.llama3_2_vision_11b import CONFIG as llama3_2_vision_11b
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny
from repro_torch.configs.zamba2_1_2b import CONFIG as zamba2_1_2b
from repro_torch.configs.rwkv6_1_6b import CONFIG as rwkv6_1_6b

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        llama3_2_1b, phi3_medium_14b, qwen2_5_14b, glm4_9b,
        granite_moe_3b_a800m, granite_moe_1b_a400m, llama3_2_vision_11b,
        whisper_tiny, zamba2_1_2b, rwkv6_1_6b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
