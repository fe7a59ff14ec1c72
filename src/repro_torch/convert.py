"""Carry the JAX package's parameters (and EF memory) into the port.

The JAX side hands over nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``); the port gets the same tree of tensors, with the
same keys, shapes, dtypes and bits, so both packages compute from the
same weights.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (CPU)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
