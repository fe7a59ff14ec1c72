"""Model and run configuration of the port (twin of ``src/repro/configs``)."""
from .base import ModelConfig, OptimizerConfig, RunConfig, ShapeConfig, \
    smoke_variant
from . import (granite_moe_1b_a400m, llama3_405b, llama_3_2_vision_11b,
               qwen1_5_32b, qwen1_5_4b, qwen3_moe_30b_a3b, rwkv6_1_6b,
               seamless_m4t_large_v2, yi_34b, zamba2_7b)
from .paper_models import LM_100M_CONFIG

ARCH_CONFIGS = {
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "llama-3.2-vision-11b": llama_3_2_vision_11b.CONFIG,
    "qwen1.5-32b": qwen1_5_32b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "yi-34b": yi_34b.CONFIG,
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    LM_100M_CONFIG.name: LM_100M_CONFIG,
}


def get_config(name: str) -> ModelConfig:
    return ARCH_CONFIGS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return smoke_variant(ARCH_CONFIGS[name])


__all__ = ["ModelConfig", "OptimizerConfig", "RunConfig", "ShapeConfig",
           "smoke_variant", "ARCH_CONFIGS", "get_config", "get_smoke_config"]
