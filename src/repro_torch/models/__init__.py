"""Models of the port (twin of ``src/repro/models``): the decoder-only
dense and MoE families, the SSM family (Mamba2 and RWKV-6), the hybrid
(Zamba2), the vlm (llama-3.2-vision) and the encoder-decoder
(seamless-m4t)."""
from .registry import Model, build_model

__all__ = ["Model", "build_model"]
