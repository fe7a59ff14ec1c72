"""Llama-3.2-11B-Vision — cross-attention VLM [hf:meta-llama/Llama-3.2-11B-Vision]
(twin of ``src/repro/configs/llama_3_2_vision_11b.py``).

40 self-attn layers (d_model=4096, 32H/8KV GQA, d_ff=14336, vocab 128256)
with gated cross-attention layers every 5th layer (8 total) attending to
ViT patch embeddings.  The vision encoder is STUBBED: the input holds the
patch embeddings (B, n_patches=4096, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5, n_patches=4096,
    rope_theta=500000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
)
