"""Llama-3 405B — dense GQA flagship [arXiv:2407.21783] (twin of
``src/repro/configs/llama3_405b.py``).

126 layers, d_model=16384, 128 heads / 8 KV heads (GQA), d_ff=53248,
vocab 128256, rope theta 500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab_size=128256,
    rope_theta=500000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="arXiv:2407.21783",
)
