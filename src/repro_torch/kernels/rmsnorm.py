"""Wrapper of the fused RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

Twin of ``src/repro/kernels/rmsnorm.py``: per row of x, ``(x *
rsqrt(mean(x^2) + eps)) * w`` in f32, written in x's type.  The wrapper
checks its tensors, launches on the current stream without
synchronising, raises on a launch error and counts its launches in
``rmsnorm.launches``.  The plain version is
:func:`repro_torch.kernels.ref.rmsnorm_reference`.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """x: (rows, D) contiguous f32/bf16 CUDA tensor, D a multiple of 8;
    w: (D,) f32/bf16 on the same card.  Returns y like x."""
    if x.device.type != "cuda" or x.dtype not in _DTYPES or x.dim() != 2 \
            or not x.is_contiguous() or x.shape[1] % 8 \
            or x.data_ptr() % 16:
        raise ValueError(f"rmsnorm: want a contiguous 16-byte aligned "
                         f"f32/bf16 CUDA (rows, D) tensor with D a multiple "
                         f"of 8, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    D = x.shape[1]
    if w.device != x.device or w.dtype not in _DTYPES \
            or tuple(w.shape) != (D,) or not w.is_contiguous() \
            or w.data_ptr() % 16:
        raise ValueError(f"rmsnorm: w must be a contiguous ({D},) f32/bf16 "
                         f"tensor on {x.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    _build.check_no_grad("rmsnorm", x, w)
    y = torch.empty_like(x)
    err = _build.load("rmsnorm").rmsnorm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0], D, float(eps),
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        _build.stream(x))
    _build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
