"""Zamba2-7B — Mamba2 backbone with shared attention blocks
[arXiv:2411.15242] (twin of ``src/repro/configs/zamba2_7b.py``).

81 Mamba2 layers (d_model=3584, ssm_state=64, expand=2) with ONE tied-weight
GQA attention+MLP block invoked every 6 layers (13 invocations + 3 tail
mamba layers). 32 heads (kv=32) of 112, d_ff=14336 for the shared block
MLP, vocab 32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6,
    rope_theta=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="arXiv:2411.15242",
)
