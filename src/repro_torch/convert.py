"""Carry the JAX package's parameters and optimizer state into the port.

The JAX side hands over trees of numpy arrays (``jax.tree.map(np.asarray,
tree)``, nested dicts and lists); the port gets the same tree of tensors,
with the same keys, shapes, dtypes and bits, so both packages compute
from the same weights.  The paper nets need no transposition: the port
keeps their JAX layouts (NHWC images, HWIO kernels; see
``configs/paper_models.py``).  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    ``device``.  An int8 EF memory leaf (anything with ``q``, ``scale``
    and ``shape``) becomes the port's ``QuantizedEF``, bits unchanged."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        from repro_torch.core.error_feedback import QuantizedEF
        return QuantizedEF(q=to_torch(tree.q, device),
                           scale=to_torch(tree.scale, device),
                           shape=tuple(tree.shape))
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    """Nested dicts/lists of tensors -> numpy arrays (CPU)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def csgd_state_to_torch(state, device="cpu"):
    """A JAX ``CSGDState`` (numpy or JAX arrays) -> the port's."""
    from repro_torch.core.csgd import CSGDState
    from repro_torch.core.telemetry import CompressionTelemetry
    f32 = np.float32
    tel = state.telemetry
    return CSGDState(
        step=int(state.step), alpha_prev=f32(state.alpha_prev),
        memory=to_torch(state.memory, device),
        n_evals_ema=f32(state.n_evals_ema), gamma=f32(state.gamma),
        telemetry=CompressionTelemetry(**{
            f: torch.tensor(f32(getattr(tel, f)), device=device)
            for f in ("ef_backlog", "cosine", "decode_error", "eff_gamma")}),
        cum_eff_bytes=f32(state.cum_eff_bytes),
        velocity=to_torch(state.velocity, device) if len(
            state.velocity) else ())
