"""SeamlessM4T-Large v2 — speech/text translation backbone
[arXiv:2308.11596] (twin of ``src/repro/configs/seamless_m4t_large_v2.py``).

Enc-dec multimodal: 24 transformer layers split 12 encoder + 12 decoder,
d_model=1024, 16 heads (kv=16 -> MHA), d_ff=8192, vocab 256206.  The audio
frontend (mel filterbank + conformer feature extractor) is STUBBED: the
encoder takes precomputed frame embeddings (B, S_enc, 1024).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    rope_theta=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    citation="arXiv:2308.11596",
)
