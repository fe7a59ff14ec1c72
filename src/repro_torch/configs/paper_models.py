"""The end-to-end training model (twin of ``LM_100M_CONFIG`` in
``src/repro/configs/paper_models.py``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

LM_100M_CONFIG = ModelConfig(
    name="paper-lm-100m",
    family="dense",
    n_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=2048, vocab_size=16384,
    rope_theta=10000.0,
    param_dtype="float32", compute_dtype="float32",
    citation="end-to-end training model (~100M params)",
)
