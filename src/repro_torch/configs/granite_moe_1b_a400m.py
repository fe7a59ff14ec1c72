"""Granite-3.0-1B-A400M — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base] (twin of
``src/repro/configs/granite_moe_1b_a400m.py``).

24 layers, d_model=1024, 16H/8KV GQA, per-expert d_ff=512, 32 experts top-8,
vocab 49155.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=32, experts_per_token=8, moe_d_ff=512,
    rope_theta=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
