"""Model and run configuration of the port (twin of ``src/repro/configs``)."""
from .base import ModelConfig, OptimizerConfig, RunConfig, ShapeConfig, \
    smoke_variant
from . import qwen1_5_4b, rwkv6_1_6b
from .paper_models import LM_100M_CONFIG

ARCH_CONFIGS = {
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
    LM_100M_CONFIG.name: LM_100M_CONFIG,
}


def get_config(name: str) -> ModelConfig:
    return ARCH_CONFIGS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return smoke_variant(ARCH_CONFIGS[name])


__all__ = ["ModelConfig", "OptimizerConfig", "RunConfig", "ShapeConfig",
           "smoke_variant", "ARCH_CONFIGS", "get_config", "get_smoke_config"]
