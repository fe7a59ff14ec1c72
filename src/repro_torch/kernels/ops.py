"""Public kernel ops — shape-normalising wrappers over the dispatch
registry (twin of ``src/repro/kernels/ops.py``: the ops of the
single-node CSGD-ASSS and DCSGD-ASSS training paths and of serving).

A CPU tensor runs the plain version, a CUDA tensor the hand-written
kernel (:mod:`repro_torch.kernels.dispatch`).  The model-side ops
(``attention``, ``rms_norm``, ``wkv``) also take ``use_kernel``: False
is the JAX package's ``impl="ref"`` (its ``use_pallas=False`` path) and
runs the plain version on any device.  The launch counts of the
CUDA wrappers are read and reset through :func:`launch_counts` /
:func:`reset_launch_counts`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F_

from . import dispatch, ef_topk, ref, rmsnorm, rwkv_wkv, wire_pack
from .flash_attention import flash_attention

dispatch.register_op("ef_stats_telemetry", ref=ref.ef_block_stats_telemetry,
                     cuda=ef_topk.ef_stats_telemetry)
dispatch.register_op("ef_stats", ref=ref.ef_block_stats,
                     cuda=ef_topk.ef_block_stats)
dispatch.register_op("block_stats", ref=ref.block_abs_topk_threshold,
                     cuda=ef_topk.block_stats)
dispatch.register_op("ef_update", ref=ref.ef_block_update,
                     cuda=ef_topk.ef_apply)
dispatch.register_op("threshold_split", ref=ref.threshold_split,
                     cuda=ef_topk.threshold_split)
dispatch.register_op("wire_pack", ref=ref.pack_fields,
                     cuda=wire_pack.pack_words)
dispatch.register_op("wire_unpack", ref=ref.unpack_fields,
                     cuda=wire_pack.unpack_words)


def _rmsnorm_rows(x, w, eps):
    """The kernel over x's rows: (..., D) -> (rows, D) and back."""
    D = x.shape[-1]
    return rmsnorm.rmsnorm(x.reshape(-1, D).contiguous(), w.contiguous(),
                           eps).reshape(x.shape)


dispatch.register_op("attention", ref=ref.mha_reference,
                     cuda=flash_attention)
dispatch.register_op("rmsnorm", ref=ref.rmsnorm_reference,
                     cuda=_rmsnorm_rows)
dispatch.register_op("wkv", ref=ref.wkv_reference,
                     cuda=rwkv_wkv.wkv_forward)

#: kernel name -> its CUDA wrapper (each carries a ``launches`` count)
KERNELS = {
    "ef_stats_telemetry": ef_topk.ef_stats_telemetry,
    "ef_block_stats": ef_topk.ef_block_stats,
    "block_stats": ef_topk.block_stats,
    "ef_apply": ef_topk.ef_apply,
    "threshold_split": ef_topk.threshold_split,
    "pack_words": wire_pack.pack_words,
    "unpack_words": wire_pack.unpack_words,
    "pack_words_ragged": wire_pack.pack_words_ragged,
    "unpack_words_ragged": wire_pack.unpack_words_ragged,
    "flash_attention": flash_attention,
    "rmsnorm": rmsnorm.rmsnorm,
    "wkv_forward": rwkv_wkv.wkv_forward,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# --------------------------------------------------------------------------
# block layout helpers
# --------------------------------------------------------------------------

def _to_blocks(x: torch.Tensor, block: int):
    """(L?, d) -> (L*nb, block) zero-padded block rows; blocks never span
    the leading (layer) axis.  1D inputs are a single layer."""
    shape = tuple(x.shape)
    L = math.prod(shape[:-1]) if x.dim() >= 2 else 1
    d = shape[-1] if x.dim() >= 1 else 1
    flat = x.reshape(L, d)
    pad = (-d) % block
    if pad:
        flat = F_.pad(flat, (0, pad))
    return flat.reshape(-1, block), (shape, L, d)


def _from_blocks(blocks: torch.Tensor, meta) -> torch.Tensor:
    shape, L, d = meta
    return blocks.reshape(L, -1)[:, :d].reshape(shape)


# --------------------------------------------------------------------------
# EF compression (the per-step hot loop)
# --------------------------------------------------------------------------

def _eta(eta, device) -> torch.Tensor:
    """eta (host scalar or tensor) as one f32 element on ``device``."""
    return torch.as_tensor(eta, dtype=torch.float32).to(device).reshape(1)


def block_topk_threshold(x: torch.Tensor, k_b: int,
                         block: int = 1024) -> torch.Tensor:
    """Per-block k_b-th largest |x| of the flattened x; (n_blocks,) f32."""
    x2, _ = _to_blocks(x.reshape(-1), block)
    return dispatch.call("block_stats", x2, k_b).reshape(-1)


def fused_ef_compress(m, g, eta, gamma: float, block: int = 1024, *,
                      telemetry: bool = False):
    """The two-pass fused EF compression of one (L?, d) leaf pair: per
    block b of ``acc = m + eta*g``, tau_b = k_b-th largest |acc_b| with
    k_b = round(gamma*block); sent keeps |acc| >= tau_b, m' the rest.
    Returns (sent, m', tau) — with ``telemetry`` also the (L*nb, 2)
    moments [sum g^2, sum acc^2] of pass 1."""
    k_b = max(1, int(round(gamma * block)))
    m2, meta = _to_blocks(m, block)
    g2, _ = _to_blocks(g, block)
    eta = _eta(eta, m2.device)
    if telemetry:
        tau, moments = dispatch.call("ef_stats_telemetry", m2, g2, eta, k_b)
    else:
        tau = dispatch.call("ef_stats", m2, g2, eta, k_b)
    sent, mnew = dispatch.call("ef_update", m2, g2, eta, tau)
    out = (_from_blocks(sent, meta), _from_blocks(mnew, meta), tau)
    return out + (moments,) if telemetry else out


def threshold_split_blocks(x: torch.Tensor, tau: torch.Tensor,
                           block: int = 1024):
    """Dense split of x ((d,) or (L, d)) into (sent, residual) against the
    per-block tau ((L*nb, 1)); ``sent + residual == x`` exactly."""
    x2, meta = _to_blocks(x, block)
    sent, res = dispatch.call("threshold_split", x2, tau)
    return _from_blocks(sent, meta), _from_blocks(res, meta)


def fused_ef_compress_batched(ms, gs, eta: torch.Tensor, gamma: float,
                              block: int = 1024):
    """Two-pass fused EF compression with telemetry over a LIST of
    (L_i, d_i) leaf pairs: ONE pass-1 and ONE pass-2 launch for the whole
    list.  Returns per-leaf ``(sent, m', tau, moments)``; every op is
    block-row-local, so the result equals per-leaf calls bit for bit."""
    k_b = max(1, int(round(gamma * block)))
    blocks_m, blocks_g, metas, offs = [], [], [], [0]
    for m, g in zip(ms, gs):
        m2, meta = _to_blocks(m, block)
        g2, _ = _to_blocks(g, block)
        blocks_m.append(m2)
        blocks_g.append(g2)
        metas.append(meta)
        offs.append(offs[-1] + m2.shape[0])
    cat_m = torch.cat(blocks_m)
    cat_g = torch.cat(blocks_g)
    eta = _eta(eta, cat_m.device)
    tau, moments = dispatch.call("ef_stats_telemetry", cat_m, cat_g, eta,
                                 k_b)
    sent, mnew = dispatch.call("ef_update", cat_m, cat_g, eta, tau)
    out = []
    for i, meta in enumerate(metas):
        rows = slice(offs[i], offs[i + 1])
        out.append((_from_blocks(sent[rows], meta),
                    _from_blocks(mnew[rows], meta), tau[rows],
                    moments[rows]))
    return out


# --------------------------------------------------------------------------
# wire pack/unpack
# --------------------------------------------------------------------------

def pack_fields(fields: torch.Tensor, bits: int, *, counts=None,
                period: int = 0) -> torch.Tensor:
    """Pack (R, n) fields into (R, ceil(n*bits/32)) int32 words; n is
    zero-padded to a whole word here.  ``counts`` + ``period``: ragged
    rows, field j zeroed when ``j % period >= counts[row]``."""
    if counts is not None and period <= 0:
        raise ValueError("ragged pack needs a positive period")
    if bits >= 32:
        return ref.pack_fields(fields, 32, counts, period)
    F = 32 // bits
    R, n = fields.shape
    pad = (-n) % F
    if pad:
        fields = F_.pad(fields, (0, pad))
    return dispatch.call("wire_pack", fields.contiguous(), bits, counts,
                         period)


def unpack_fields(words: torch.Tensor, n: int, bits: int, *, counts=None,
                  period: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_fields`: (R, W) words -> the first ``n``
    fields, zero beyond the per-row ``counts`` when given."""
    if counts is not None and period <= 0:
        raise ValueError("ragged unpack needs a positive period")
    if bits >= 32:
        return ref.unpack_fields(words, 32, counts, period)
    out = dispatch.call("wire_unpack", words.contiguous(), bits, counts,
                        period)
    return out[:, :n]


def pack_fields_stream(fields: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack a FLAT word-aligned field stream (N,) into (N*bits/32,) words
    in ONE launch (the bucket-shaped launch)."""
    fields = fields.to(torch.int32)
    if bits >= 32:
        return fields
    F = 32 // bits
    (n,) = fields.shape
    if n % F:
        raise ValueError(f"stream of {n} {bits}-bit fields is not "
                         f"word-aligned (need a multiple of {F})")
    W = n // F
    R, C = wire_pack.stream_shape(W)
    pad = R * C - W
    if pad:
        fields = F_.pad(fields, (0, pad * F))
    words = dispatch.call("wire_pack", fields.reshape(R, C * F), bits,
                          None, 0)
    return words.reshape(-1)[:W]


def unpack_fields_stream(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_fields_stream`: (W,) words -> the
    (W*32/bits,) field stream, one launch."""
    words = words.to(torch.int32)
    if bits >= 32:
        return words
    F = 32 // bits
    (W,) = words.shape
    R, C = wire_pack.stream_shape(W)
    pad = R * C - W
    if pad:
        words = F_.pad(words, (0, pad))
    fields = dispatch.call("wire_unpack", words.reshape(R, C), bits, None, 0)
    return fields.reshape(-1)[:W * F]


# --------------------------------------------------------------------------
# serving: attention, RMSNorm, the RWKV-6 recurrence
# --------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              use_kernel: bool = True):
    """Attention over (B, H, S, D) q, k, v (GQA heads broadcast by the
    caller), scaled by 1/sqrt(D), the queries at the trailing positions."""
    if not use_kernel:
        return ref.mha_reference(q, k, v, causal=causal, window=window)
    return dispatch.call("attention", q, k, v, causal=causal, window=window)


def rms_norm(x, w, *, eps: float = 1e-6, use_kernel: bool = True):
    """RMSNorm over the last axis of x with weight w (D,)."""
    if not use_kernel:
        return ref.rmsnorm_reference(x, w, eps)
    return dispatch.call("rmsnorm", x, w, eps)


def wkv(r, k, v, w, u, s0, *, use_kernel: bool = True):
    """The RWKV-6 WKV recurrence (``kernels/rwkv_wkv.py``); returns
    (y, final state)."""
    if not use_kernel:
        return ref.wkv_reference(r, k, v, w, u, s0)
    return dispatch.call("wkv", r, k, v, w, u, s0)
