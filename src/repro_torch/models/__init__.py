"""Decoder-only LMs of the port (twin of ``src/repro/models``): the dense
and MoE families, the SSM family (Mamba2 and RWKV-6) and the hybrid
(Zamba2)."""
from .registry import Model, build_model

__all__ = ["Model", "build_model"]
