"""Decoder-only LMs of the port (twin of ``src/repro/models``): the dense
family and RWKV-6."""
from .registry import Model, build_model

__all__ = ["Model", "build_model"]
