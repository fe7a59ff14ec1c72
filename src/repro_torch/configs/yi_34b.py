"""Yi-34B — llama-architecture dense GQA [arXiv:2403.04652] (twin of
``src/repro/configs/yi_34b.py``).

60 layers, d_model=7168, 56 heads / 8 KV heads, d_ff=20480, vocab 64000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    rope_theta=5000000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="arXiv:2403.04652",
)
