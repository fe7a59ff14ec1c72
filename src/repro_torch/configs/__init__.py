"""Model and run configuration of the port (twin of ``src/repro/configs``)."""
from .base import ModelConfig, OptimizerConfig, RunConfig, ShapeConfig, \
    smoke_variant
from .paper_models import LM_100M_CONFIG

ARCH_CONFIGS = {LM_100M_CONFIG.name: LM_100M_CONFIG}


def get_config(name: str) -> ModelConfig:
    return ARCH_CONFIGS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return smoke_variant(ARCH_CONFIGS[name])


__all__ = ["ModelConfig", "OptimizerConfig", "RunConfig", "ShapeConfig",
           "smoke_variant", "ARCH_CONFIGS", "get_config", "get_smoke_config"]
