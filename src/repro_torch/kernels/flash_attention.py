"""Wrapper of the flash-attention forward CUDA kernels.

Twin of ``src/repro/kernels/flash_attention.py``: online-softmax attention
over KV tiles, causal and/or sliding window, queries at the trailing
positions (offset Sk - Sq), f32 accumulation, output in q's type.
Without causality Sq may exceed Sk (an encoder-decoder's cross attention:
the decoder's positions against the encoder's frames): the offset is
then negative, which masks nothing without a window and leaves every
row key Sk - 1 with one, so no row is empty.  Causal attention keeps
Sq <= Sk: with Sq > Sk its first Sq - Sk rows would see no key at all
(the plain version averages them uniformly, the kernels give 0).  The
route is chosen by dtype, explicitly: bf16 takes the tensor-core kernel
(``csrc/flash_attention_sm90.cu``: wgmma products, TMA loads, the scale
applied to the f32 logits), f32 the CUDA-core kernel
(``csrc/flash_attention.cu``: exact f32 products, ``q * scale`` formed
before them).  Both count in ``flash_attention.launches``; a failure to
build or launch either raises, with no fallback.  The kernels read q, k
and v through their strides, so the transposed (B, S, H, D) views the
model hands over are taken as they are, without a copy; only the last
axis must be contiguous.  Head dim 112 (zamba2-7b) is an instance of
both kernels; the bf16 one reads it through tensor maps that zero-fill
its tiles to 128 columns, with no padding copy here.  The output is
allocated in the (B, Sq, H, D) layout and returned as its (B, H, Sq, D)
view, so the model's transpose back is free too.  The wrapper checks
its tensors, launches on the current stream without synchronising and
raises on a launch error.  The plain version is
:func:`repro_torch.kernels.ref.mha_reference`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (32, 64, 112, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, t: torch.Tensor, like: torch.Tensor | None) -> None:
    if t.device.type != "cuda" or t.dtype not in _DTYPES or t.dim() != 4 \
            or t.stride(3) != 1 or t.data_ptr() % 16 \
            or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(
            f"flash_attention: {name} must be a 4-D f32/bf16 CUDA tensor "
            f"with a contiguous last axis, 16-byte aligned, its other "
            f"strides multiples of 8; got {t.dtype} {tuple(t.shape)} "
            f"strides {t.stride()} on {t.device}")
    if like is not None and (t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                         f"{t.device}, q is {like.dtype} on {like.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, H, Sk, D) with Sq <= Sk when
    ``causal`` (any Sq >= 1 otherwise), D in (32, 64, 112, 128), f32 or
    bf16 on one card (GQA heads broadcast by the caller); logits scaled
    by 1/sqrt(D).  Returns (B, H, Sq, D) in q's type."""
    _check("q", q, None)
    _check("k", k, q)
    _check("v", v, q)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if tuple(k.shape) != (B, H, Sk, D) or tuple(v.shape) != (B, H, Sk, D) \
            or D not in HEAD_DIMS or Sq < 1 or Sk < 1 \
            or (causal and Sq > Sk):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, causal "
                         f"{causal}: want Sq, Sk >= 1, Sq <= Sk when causal"
                         f" and D in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    _build.check_no_grad("flash_attention", q, k, v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, H, Sq, Sk, D, 1.0 / (D ** 0.5), int(causal),
            int(window or 0))
    if q.dtype == torch.bfloat16:
        err = _build.load("flash_attention_sm90").flash_attention_sm90_launch(
            *args, _build.stream(q))
    else:                                   # f32, as _check leaves it
        err = _build.load("flash_attention").flash_attention_launch(
            *args, _build.stream(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
