"""Qwen3-30B-A3B — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B] (twin of
``src/repro/configs/qwen3_moe_30b_a3b.py``).

48 layers, d_model=2048, 32H/4KV GQA (head_dim=128), 128 experts top-8 with
per-expert d_ff=768, vocab 151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    n_experts=128, experts_per_token=8, moe_d_ff=768,
    rope_theta=1000000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="hf:Qwen/Qwen3-30B-A3B",
)
