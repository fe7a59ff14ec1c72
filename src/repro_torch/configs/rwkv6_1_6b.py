"""RWKV-6 "Finch" 1.6B — attention-free linear RNN with data-dependent
decay [arXiv:2404.05892] (twin of ``src/repro/configs/rwkv6_1_6b.py``).

24 layers, d_model=2048 (32 heads x 64), channel-mix d_ff=7168, vocab 65536.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    rwkv_lora_rank=64,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="arXiv:2404.05892",
)
