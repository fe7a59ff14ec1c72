"""Error-feedback memory state (twin of ``src/repro/core/error_feedback.py``).

    g_t     = top_k(m_t + eta_t * grad_t)
    m_{t+1} = m_t + eta_t * grad_t - g_t

The port keeps the memory in float32; the int8 ``QuantizedEF`` storage of
the JAX package is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.utils import tree_map


def init_ef(params):
    """m_0 = 0 in float32, shaped like params (per worker in DCSGD)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
