"""Error-feedback memory state (twin of ``src/repro/core/error_feedback.py``).

    g_t     = top_k(m_t + eta_t * grad_t)
    m_{t+1} = m_t + eta_t * grad_t - g_t

The memory is kept in float32, bfloat16, or as int8 with one absmax
scale per block of 256 values (:class:`QuantizedEF`, 4x smaller than
f32).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import tree_map
from .compression import quant_scale

EF_QBLOCK = 256


def init_ef(params, dtype=torch.float32):
    """m_0 = 0 shaped like params (per worker in DCSGD)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


@dataclasses.dataclass(frozen=True)
class QuantizedEF:
    """Per-block absmax-scaled int8 residual storage."""

    q: torch.Tensor        # int8, the padded flat leaf as (nb, EF_QBLOCK)
    scale: torch.Tensor    # f32 (nb, 1)
    shape: tuple


def quantize_ef(m: torch.Tensor) -> QuantizedEF:
    """int8 blocks of ``m``.  The scale max|block| / 127 + 1e-30 is
    :func:`quant_scale`'s jitted form (eager JAX divides and differs in
    the last bit for a few blocks in a hundred)."""
    flat = m.reshape(-1).float()
    pad = (-flat.numel()) % EF_QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, EF_QBLOCK)
    scale = quant_scale(blocks, 127.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QuantizedEF(q=q, scale=scale, shape=tuple(m.shape))


def dequantize_ef(qef: QuantizedEF, dtype=torch.float32) -> torch.Tensor:
    d = int(np.prod(qef.shape))
    flat = (qef.q.float() * qef.scale).reshape(-1)[:d]
    return flat.reshape(qef.shape).to(dtype)


def init_ef_quantized(params):
    return tree_map(lambda p: quantize_ef(torch.zeros(
        p.shape, dtype=torch.float32, device=p.device)), params)
