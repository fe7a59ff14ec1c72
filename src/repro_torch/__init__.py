"""PyTorch + CUDA port of the DCSGD-ASSS training path.

A second package beside the JAX reference ``repro``; each module has a
JAX twin at the same relative path.  It imports ``torch`` and numpy,
never ``jax`` or ``repro``.
"""
