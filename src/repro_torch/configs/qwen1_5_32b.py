"""Qwen1.5-32B — dense MHA with QKV bias [hf:Qwen/Qwen1.5-0.5B family]
(twin of ``src/repro/configs/qwen1_5_32b.py``).

64 layers, d_model=5120, 40 heads (kv=40 -> MHA), d_ff=27392, vocab 152064,
QKV bias on.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="hf:Qwen/Qwen1.5-0.5B",
)
