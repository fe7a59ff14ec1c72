"""Wrappers of the fused error-feedback CUDA kernels (``csrc/ef_topk.cu``).

Twins of ``src/repro/kernels/ef_topk.py``'s ``ef_stats_telemetry``
(pass 1: per-block-row k_b-th largest |m + eta*g| and the moments
[sum g^2, sum acc^2]) and ``ef_apply`` (pass 2: sent and the new EF
memory).  Each wrapper checks its tensors, launches on the current stream
without synchronising, raises on a launch error and counts its launches
in ``<wrapper>.launches``.  The plain versions live in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.dispatch` picks
by device.
"""
from __future__ import annotations

import torch

from . import _build

COLS = 1024


def _check_rows(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 2 \
                or t.shape[1] != COLS or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: want contiguous 16-byte aligned f32 CUDA "
                f"(rows, {COLS}) tensors, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if ts[0].shape != ts[1].shape or ts[0].device != ts[1].device:
        raise ValueError(f"{name}: m and g differ in shape or device")


def _check_eta(name: str, eta: torch.Tensor, like: torch.Tensor) -> None:
    if eta.device != like.device or eta.dtype != torch.float32 \
            or eta.numel() != 1:
        raise ValueError(f"{name}: eta must be one f32 element on "
                         f"{like.device}, got {eta.dtype} "
                         f"{tuple(eta.shape)} on {eta.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ef_stats_telemetry(m: torch.Tensor, g: torch.Tensor, eta: torch.Tensor,
                       k_b: int):
    """Pass 1.  m, g: (R, 1024) f32; eta: one f32 element on the card.
    Returns (tau (R, 1), moments (R, 2)) f32."""
    _check_rows("ef_stats_telemetry", m, g)
    _check_eta("ef_stats_telemetry", eta, m)
    if not 1 <= k_b <= COLS:
        raise ValueError(f"ef_stats_telemetry: k_b={k_b} not in "
                         f"[1, {COLS}]")
    R = m.shape[0]
    tau = torch.empty((R, 1), dtype=torch.float32, device=m.device)
    moments = torch.empty((R, 2), dtype=torch.float32, device=m.device)
    eta = eta.contiguous()
    err = _build.load("ef_topk").ef_stats_telemetry_launch(
        m.data_ptr(), g.data_ptr(), eta.data_ptr(), tau.data_ptr(),
        moments.data_ptr(), R, k_b, _stream(m))
    _build.check(err, "ef_stats_telemetry")
    ef_stats_telemetry.launches += 1
    return tau, moments


ef_stats_telemetry.launches = 0


def ef_apply(m: torch.Tensor, g: torch.Tensor, eta: torch.Tensor,
             tau: torch.Tensor):
    """Pass 2.  m, g: (R, 1024) f32; tau: (R, 1) f32.  Returns
    (sent, m') with ``sent + m' == fma(eta, g, m)`` exactly."""
    _check_rows("ef_apply", m, g)
    _check_eta("ef_apply", eta, m)
    R = m.shape[0]
    if tau.device != m.device or tau.dtype != torch.float32 \
            or tau.numel() != R:
        raise ValueError(f"ef_apply: tau must be {R} f32 values on "
                         f"{m.device}, got {tau.dtype} {tuple(tau.shape)}")
    tau = tau.contiguous()
    eta = eta.contiguous()
    sent = torch.empty_like(m)
    mnew = torch.empty_like(m)
    err = _build.load("ef_topk").ef_apply_launch(
        m.data_ptr(), g.data_ptr(), eta.data_ptr(), tau.data_ptr(),
        sent.data_ptr(), mnew.data_ptr(), R, _stream(m))
    _build.check(err, "ef_apply")
    ef_apply.launches += 1
    return sent, mnew


ef_apply.launches = 0
