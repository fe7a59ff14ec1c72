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
    w: (D,) f32/bf16 on the same card.  Returns y like x.  Each tensor
    property is read once: at decode the host's time per launch is the
    step's time."""
    x_ptr, w_ptr, xdt, wdt, shape = (x.data_ptr(), w.data_ptr(), x.dtype,
                                     w.dtype, x.shape)
    dev = x.get_device()
    if not x.is_cuda or xdt not in _DTYPES or len(shape) != 2 \
            or shape[1] % 8 or x_ptr % 16 or not x.is_contiguous():
        raise ValueError(f"rmsnorm: want a contiguous 16-byte aligned "
                         f"f32/bf16 CUDA (rows, D) tensor with D a multiple "
                         f"of 8, got {xdt} {tuple(shape)} on {x.device}")
    rows, D = shape
    if not w.is_cuda or w.get_device() != dev or wdt not in _DTYPES \
            or w.shape != (D,) or w_ptr % 16 or not w.is_contiguous():
        raise ValueError(f"rmsnorm: w must be a contiguous ({D},) f32/bf16 "
                         f"tensor on {x.device}, got {wdt} "
                         f"{tuple(w.shape)} on {w.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        _build.check_no_grad("rmsnorm", x, w)      # raises
    y = torch.empty_like(x)
    err = _build.load("rmsnorm").rmsnorm_launch(
        x_ptr, w_ptr, y.data_ptr(), rows, D, eps, xdt is torch.bfloat16,
        wdt is torch.bfloat16, _build.raw_stream(dev))
    if err:
        _build.check(err, "rmsnorm")               # raises
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
