"""Wrapper of the RWKV-6 WKV recurrence CUDA kernel (``csrc/rwkv_wkv.cu``).

Twin of ``src/repro/kernels/rwkv_wkv.py``'s ``wkv_forward``: per (batch,
head), with the (K, V) state on chip for the whole sequence,
``y_t = r_t (S + diag(u) k_t^T v_t)`` and ``S <- diag(w_t) S + k_t^T
v_t``, all in f32.  The wrapper checks its tensors, launches on the
current stream without synchronising, raises on a launch error and
counts its launches in ``wkv_forward.launches``.  The plain version is
:func:`repro_torch.kernels.ref.wkv_reference`.
"""
from __future__ import annotations

import torch

from . import _build

KEY_DIMS = (32, 64)


def _check(name: str, t: torch.Tensor, shape: tuple, like) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 \
            or not t.is_contiguous() or tuple(t.shape) != shape \
            or (like is not None and t.device != like.device):
        raise ValueError(f"wkv_forward: {name} must be a contiguous f32 "
                         f"CUDA tensor of shape {shape} on one card, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def wkv_forward(r, k, v, w, u, s0):
    """r, k, w: (B, S, H, K) with K in (32, 64); v: (B, S, H, V),
    V <= 1024; u: (H, K); s0: (B, H, K, V); all contiguous f32 on one
    card.  Returns (y (B, S, H, V), sT (B, H, K, V)) f32."""
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"wkv_forward: want 4-D r and v, got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    B, S, H, K = r.shape
    V = v.shape[3]
    if K not in KEY_DIMS or not 1 <= V <= 1024:
        raise ValueError(f"wkv_forward: K={K} not in {KEY_DIMS} or "
                         f"V={V} not in [1, 1024]")
    _check("r", r, (B, S, H, K), None)
    for name, t, shape in (("k", k, (B, S, H, K)), ("w", w, (B, S, H, K)),
                           ("v", v, (B, S, H, V)), ("u", u, (H, K)),
                           ("s0", s0, (B, H, K, V))):
        _check(name, t, shape, r)
    _build.check_no_grad("wkv_forward", r, k, v, w, u, s0)
    y = torch.empty((B, S, H, V), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    err = _build.load("rwkv_wkv").wkv_forward_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, S, H,
        K, V, _build.stream(r))
    _build.check(err, "wkv_forward")
    wkv_forward.launches += 1
    return y, sT


wkv_forward.launches = 0
