"""Config system (twin of ``src/repro/configs/base.py``): the fields the
DCSGD-ASSS training path of the dense LM family reads."""
from __future__ import annotations

import dataclasses

from repro_torch.core.armijo import ArmijoConfig
from repro_torch.core.compression import Compressor


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # the port has the dense family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    citation: str = ""

    def __post_init__(self):
        if self.family != "dense":
            raise ValueError(f"model family {self.family!r} is not ported "
                             "(the port has 'dense')")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 256 multiple; padded logits are masked."""
        return -(-self.vocab_size // 256) * 256


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    seq_len: int
    global_batch: int


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The csgd_asss optimizer (the port's only kind so far)."""

    armijo: ArmijoConfig = ArmijoConfig()
    compressor: Compressor = Compressor()


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = OptimizerConfig()


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests: 2 layers, d_model 128."""
    return dataclasses.replace(
        cfg, n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        d_ff=256, vocab_size=512, head_dim=32, param_dtype="float32",
        compute_dtype="float32")
