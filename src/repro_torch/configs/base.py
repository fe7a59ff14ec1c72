"""Config system (twin of ``src/repro/configs/base.py``): the fields the
training paths of the dense LM and the serving paths of the dense LM and
RWKV-6 read."""
from __future__ import annotations

import dataclasses

from repro_torch.core.armijo import ArmijoConfig
from repro_torch.core.compression import Compressor
from repro_torch.core.gamma import GammaControllerConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm (RWKV-6 only, by name)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    rwkv_lora_rank: int = 64
    sliding_window: int = 0       # 0 = full attention
    # the int8 KV cache and rematerialisation are not ported: only the
    # defaults are accepted (remat changes memory, never values)
    kv_cache_dtype: str = ""      # "" = compute dtype
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_chunk: int = 1024        # query-chunked attention above this seq len
    remat: bool = True
    # JAX: "flip on real TPU".  In the port: take the hand-written CUDA
    # kernels (flash attention, RMSNorm, WKV) for CUDA tensors; False
    # computes what the JAX package's jnp path computes on any device.
    use_pallas: bool = False
    citation: str = ""

    def __post_init__(self):
        if not (self.family == "dense"
                or (self.family == "ssm" and self.name.startswith("rwkv"))):
            raise ValueError(f"model family {self.family!r} of "
                             f"{self.name!r} is not ported (the port has "
                             "'dense' and the RWKV-6 'ssm' models)")
        if self.kv_cache_dtype != "" or not self.remat:
            raise ValueError("kv_cache_dtype and remat: the port takes only "
                             "their defaults ('' and True)")

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
    # per-round compression level (core/gamma.py); the schedule moves
    # gamma_t when compressor.max_gamma > 0 sizes the ragged wire budget
    gamma_controller: GammaControllerConfig = GammaControllerConfig()
    # exchange schedule, validated against the comm.transport registry:
    # "bucketed" (one flat all_gather a step) or "perleaf" (the reference,
    # one all_gather a leaf)
    transport: str = "bucketed"

    def __post_init__(self):
        from repro_torch.comm.transport import validate_transport
        validate_transport(self.transport)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    optimizer: OptimizerConfig = OptimizerConfig()


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests: 2 layers, d_model 128,
    query chunks of 64, LoRA rank 8 for RWKV (JAX's ``smoke_variant``
    less the fields the port does not read)."""
    kw = dict(n_layers=2, d_model=128, n_heads=4,
              n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
              d_ff=256, vocab_size=512, head_dim=32, param_dtype="float32",
              compute_dtype="float32", attn_chunk=64)
    if cfg.name.startswith("rwkv"):
        kw.update(rwkv_lora_rank=8)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return dataclasses.replace(cfg, **kw)
