"""Carry the JAX package's parameters and optimizer state into the port.

The JAX side hands over trees of numpy arrays (``jax.tree.map(np.asarray,
tree)``, nested dicts, lists and named tuples); the port gets the same
tree of tensors, with the same keys, shapes, dtypes and bits, so both
packages compute from the same weights.  The paper nets need no
transposition: the port keeps their JAX layouts (NHWC images, HWIO
kernels; see ``configs/paper_models.py``).  Nothing here imports JAX.

bf16 leaves: ``np.asarray`` of a JAX bf16 array has the ``ml_dtypes``
bfloat16 dtype, which ``torch.from_numpy`` refuses; such a leaf is
recognised by its dtype's name and carried over as its 16-bit pattern
(``.view(np.uint16)``, then ``.view(torch.bfloat16)``), bits unchanged.
The serving caches (``DecodeCache``, ``KVCache``, ``RWKVState``,
``SSMState``) become the port's named tuples of the same name and fields
(a hybrid's ``tail_ssm`` and an encoder-decoder's or a vlm's
``cross_kv`` included).  A vlm's f32 gates carry over beside its bf16
or f32 weights.  An MoE tree
carries over leaf by leaf like any other: its f32 router beside bf16 or
f32 experts.
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
    if hasattr(tree, "_fields") and type(tree).__name__ in _CACHES:
        return _cache_twin(tree, device)
    if isinstance(tree, tuple) and not tree:
        return ()                        # an unused cache field
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        from repro_torch.core.error_feedback import QuantizedEF
        return QuantizedEF(q=to_torch(tree.q, device),
                           scale=to_torch(tree.scale, device),
                           shape=tuple(tree.shape))
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


_CACHES = ("DecodeCache", "KVCache", "RWKVState", "SSMState")


def _cache_twin(tree, device):
    """A JAX cache named tuple -> the port's twin, field by field (an
    int8 KVCache with its scales)."""
    from repro_torch.models import attention, lm, rwkv, ssm
    cls = {"DecodeCache": lm.DecodeCache, "KVCache": attention.KVCache,
           "RWKVState": rwkv.RWKVState,
           "SSMState": ssm.SSMState}[type(tree).__name__]
    extra = [f for f in tree._fields if f not in cls._fields
             and not (isinstance(getattr(tree, f), tuple)
                      and not getattr(tree, f))]
    if extra:
        raise ValueError(f"{type(tree).__name__} fields {extra} have no "
                         "twin in the port")
    return cls(*(to_torch(getattr(tree, f), device) for f in cls._fields))


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
            for f in ("ef_backlog", "cosine", "decode_error", "eff_gamma",
                      "rows_quarantined")}),
        cum_eff_bytes=f32(state.cum_eff_bytes),
        velocity=to_torch(state.velocity, device) if len(
            state.velocity) else ())
