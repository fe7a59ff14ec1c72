"""Wrappers of the fused error-feedback CUDA kernels (``csrc/ef_topk.cu``).

Twins of ``src/repro/kernels/ef_topk.py``: the pass-1 selection kernels
``ef_stats_telemetry`` (per-block-row k_b-th largest |m + eta*g| and the
moments [sum g^2, sum acc^2]), ``ef_block_stats`` (the same tau without
moments) and ``block_stats`` (k_b-th largest |x| of a single input), and
the splits ``ef_apply`` (sent and the new EF memory) and
``threshold_split`` (sent and the residual of x).  A row holding a NaN
gets tau = NaN, as on the TPU.  Each wrapper checks its tensors, launches
on the current stream without synchronising, raises on a launch error and
counts its launches in ``<wrapper>.launches``.  The plain versions live
in :mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.dispatch`
picks by device.
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
    if any(t.shape != ts[0].shape or t.device != ts[0].device
           for t in ts[1:]):
        raise ValueError(f"{name}: m and g differ in shape or device")


def _check_eta(name: str, eta: torch.Tensor, like: torch.Tensor) -> None:
    if eta.device != like.device or eta.dtype != torch.float32 \
            or eta.numel() != 1:
        raise ValueError(f"{name}: eta must be one f32 element on "
                         f"{like.device}, got {eta.dtype} "
                         f"{tuple(eta.shape)} on {eta.device}")


def _check_k(name: str, k_b: int) -> None:
    if not 1 <= k_b <= COLS:
        raise ValueError(f"{name}: k_b={k_b} not in [1, {COLS}]")


def _check_tau(name: str, tau: torch.Tensor, like: torch.Tensor) -> None:
    R = like.shape[0]
    if tau.device != like.device or tau.dtype != torch.float32 \
            or tau.numel() != R:
        raise ValueError(f"{name}: tau must be {R} f32 values on "
                         f"{like.device}, got {tau.dtype} {tuple(tau.shape)}")


def ef_stats_telemetry(m: torch.Tensor, g: torch.Tensor, eta: torch.Tensor,
                       k_b: int):
    """Pass 1 with moments.  m, g: (R, 1024) f32; eta: one f32 element on
    the card.  Returns (tau (R, 1), moments (R, 2)) f32."""
    _check_rows("ef_stats_telemetry", m, g)
    _check_eta("ef_stats_telemetry", eta, m)
    _check_k("ef_stats_telemetry", k_b)
    R = m.shape[0]
    tau = torch.empty((R, 1), dtype=torch.float32, device=m.device)
    moments = torch.empty((R, 2), dtype=torch.float32, device=m.device)
    eta = eta.contiguous()
    err = _build.load("ef_topk").ef_stats_telemetry_launch(
        m.data_ptr(), g.data_ptr(), eta.data_ptr(), tau.data_ptr(),
        moments.data_ptr(), R, k_b, _build.stream(m))
    _build.check(err, "ef_stats_telemetry")
    ef_stats_telemetry.launches += 1
    return tau, moments


ef_stats_telemetry.launches = 0


def ef_block_stats(m: torch.Tensor, g: torch.Tensor, eta: torch.Tensor,
                   k_b: int) -> torch.Tensor:
    """Pass 1 without moments.  m, g: (R, 1024) f32; eta: one f32
    element on the card.  Returns tau (R, 1) f32."""
    _check_rows("ef_block_stats", m, g)
    _check_eta("ef_block_stats", eta, m)
    _check_k("ef_block_stats", k_b)
    tau = torch.empty((m.shape[0], 1), dtype=torch.float32, device=m.device)
    eta = eta.contiguous()
    err = _build.load("ef_topk").ef_block_stats_launch(
        m.data_ptr(), g.data_ptr(), eta.data_ptr(), tau.data_ptr(),
        m.shape[0], k_b, _build.stream(m))
    _build.check(err, "ef_block_stats")
    ef_block_stats.launches += 1
    return tau


ef_block_stats.launches = 0


def block_stats(x: torch.Tensor, k_b: int) -> torch.Tensor:
    """Per-block-row k_b-th largest |x|.  x: (R, 1024) f32.  Returns tau
    (R, 1) f32."""
    _check_rows("block_stats", x)
    _check_k("block_stats", k_b)
    tau = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    err = _build.load("ef_topk").block_stats_launch(
        x.data_ptr(), tau.data_ptr(), x.shape[0], k_b, _build.stream(x))
    _build.check(err, "block_stats")
    block_stats.launches += 1
    return tau


block_stats.launches = 0


def ef_apply(m: torch.Tensor, g: torch.Tensor, eta: torch.Tensor,
             tau: torch.Tensor):
    """Pass 2.  m, g: (R, 1024) f32; tau: (R, 1) f32.  Returns
    (sent, m') with ``sent + m' == fma(eta, g, m)`` exactly."""
    _check_rows("ef_apply", m, g)
    _check_eta("ef_apply", eta, m)
    _check_tau("ef_apply", tau, m)
    tau = tau.contiguous()
    eta = eta.contiguous()
    sent = torch.empty_like(m)
    mnew = torch.empty_like(m)
    err = _build.load("ef_topk").ef_apply_launch(
        m.data_ptr(), g.data_ptr(), eta.data_ptr(), tau.data_ptr(),
        sent.data_ptr(), mnew.data_ptr(), m.shape[0], _build.stream(m))
    _build.check(err, "ef_apply")
    ef_apply.launches += 1
    return sent, mnew


ef_apply.launches = 0


def threshold_split(x: torch.Tensor, tau: torch.Tensor):
    """x: (R, 1024) f32; tau: (R, 1) f32.  Returns (sent, residual) with
    ``sent + residual == x`` exactly."""
    _check_rows("threshold_split", x)
    _check_tau("threshold_split", tau, x)
    tau = tau.contiguous()
    sent = torch.empty_like(x)
    resid = torch.empty_like(x)
    err = _build.load("ef_topk").threshold_split_launch(
        x.data_ptr(), tau.data_ptr(), sent.data_ptr(), resid.data_ptr(),
        x.shape[0], _build.stream(x))
    _build.check(err, "threshold_split")
    threshold_split.launches += 1
    return sent, resid


threshold_split.launches = 0
