"""Qwen1.5-4B — dense MHA with QKV bias [hf:Qwen/Qwen1.5-0.5B family]
(twin of ``src/repro/configs/qwen1_5_4b.py``).

40 layers, d_model=2560, 20 heads (kv=20 -> MHA), d_ff=6912, vocab 151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="hf:Qwen/Qwen1.5-0.5B",
)
