"""Attention (twin of ``src/repro/models/attention.py``): GQA with rotary
embeddings and QKV bias; full-sequence attention for training and
prefill, causal or not (the encoder), one-token attention against a KV
cache for decode, and cross attention from a stream into a memory (the
encoder's output), whose K/V are projected once and reused at decode.

Full-sequence attention takes one of two routes (``_sdpa``):

* ``cfg.use_pallas`` and CUDA tensors: the flash-attention kernel, ONE
  launch over the whole query length;
* otherwise the plain attention of :mod:`repro_torch.kernels.ref`, in
  query chunks of ``cfg.attn_chunk`` when the sequence is longer, as the
  JAX package's jnp path computes it (the chunks only bound the (Sq, Sk)
  logits the plain version holds).

Causality and the window are arguments of ``_sdpa``, as in JAX: the
cross attention passes ``causal=False, window=None`` whatever the
config's window.  Queries sit at the trailing positions (offset Sk -
Sq), which masks nothing without causality or a window: the cross
attention's Sq may exceed its Sk.

Decode attention is the JAX package's plain einsums in f32 over the
whole cache, with the positions past the current one masked.

With ``cfg.kv_cache_dtype == "int8"`` a self-attention cache holds int8
codes and f32 absmax scales, one a (position, head) (``quantize_kv``):
prefill attends with the unquantized k and v, then stores their codes;
a decode step stores the new token's codes and attends over the whole
cache dequantized to the compute dtype.  Cross K/V stay in the compute
dtype, as in JAX.

Under a mesh each rank holds the heads of its ``wq``/``wk``/``wv``
column slices, H/M query and H_kv/M kv heads (the head counts come from
the weights' shapes, not the config; the GQA map ``h // rep`` keeps its
meaning, as rep is the same on every rank), attends over them alone and
adds its ``wo`` row slice's partial product over the model axis.  Each
rank caches its own kv heads, the full sequence of each: JAX hints its
decode cache sequence-sharded over ``model`` instead (a layout the
partitioner turns into a flash-decoding combine); the values a rank
attends to are the same either way, and no collective writes a cache.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from .layers import apply_rope, dense, he_init, row_dense


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S_max, H_kv, hd), the compute dtype or int8
    v: torch.Tensor      # (B, S_max, H_kv, hd)
    k_scale: Any = ()    # (B, S_max, H_kv, 1) f32 absmax scales (int8 only)
    v_scale: Any = ()

    @property
    def quantized(self) -> bool:
        return isinstance(self.k_scale, torch.Tensor)

    def at(self, i) -> "KVCache":
        """Slot ``i`` of a cache stacked on leading layer axes (views, so
        writes reach the stack)."""
        return KVCache(*(t[i] if isinstance(t, torch.Tensor) else t
                         for t in self))


#: f32(1/127) and f32(1e-30), exactly, as Python floats
_INV127 = float(np.float32(1.0) / np.float32(127.0))
_TINY = float(np.float32(1e-30))


def _kv_scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127 + 1e-30`` as jitted XLA computes it: the division by
    the constant becomes a product with f32(1/127), and the product and
    the sum contract into one fused multiply-add, rounded once to f32
    (eager JAX divides and rounds twice: other bits in a few rows; a
    product rounded before the sum: other bits in ~2% of bf16 rows).
    The product of two f32 values is exact in f64; the sum's rounding
    error (TwoSum) breaks the tie where the f64 sum falls halfway
    between two f32 values, so the f32 result is the exact sum's."""
    p = amax.double() * _INV127
    s = p + _TINY
    b = s - p
    err = (p - (s - b)) + (_TINY - b)
    bits = s.view(torch.int64)
    half = (bits & ((1 << 29) - 1)) == (1 << 28)
    bits = bits + (half & (err > 0)).long() - (half & (err < 0)).long()
    return bits.view(torch.float64).float()


def quantize_kv(x: torch.Tensor):
    """Per-(position, head) absmax int8 quantization of a K/V tensor:
    (codes int8, scales f32 (..., 1)), as jitted JAX computes them: the
    scale :func:`_kv_scale` of the row's absmax, the codes the true
    quotient rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = _kv_scale(xf.abs().amax(-1, keepdim=True))
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    """The codes times their scales in f32, rounded to ``dtype`` (the
    int8 codes promote to f32 exactly inside the one product pass)."""
    return (q * scale).to(dtype)


def maybe_quantize_cache(kv: KVCache, cfg) -> KVCache:
    """``kv`` quantized when the config asks for the int8 cache."""
    if cfg.kv_cache_dtype != "int8":
        return kv
    kq, ks = quantize_kv(kv.k)
    vq, vs = quantize_kv(kv.v)
    return KVCache(k=kq, v=vq, k_scale=ks, v_scale=vs)


def init_attn(gen, cfg, dtype, lead=()):
    D, hd = cfg.d_model, cfg.hd
    p = {
        "wq": {"w": he_init(gen, (D, cfg.n_heads * hd), dtype, lead=lead)},
        "wk": {"w": he_init(gen, (D, cfg.n_kv_heads * hd), dtype,
                            lead=lead)},
        "wv": {"w": he_init(gen, (D, cfg.n_kv_heads * hd), dtype,
                            lead=lead)},
        "wo": {"w": he_init(gen, (cfg.n_heads * hd, D), dtype, lead=lead)},
    }
    if cfg.qkv_bias:
        for n, d_out in (("wq", cfg.n_heads * hd), ("wk", cfg.n_kv_heads * hd),
                         ("wv", cfg.n_kv_heads * hd)):
            p[n]["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                                    device=gen.device)
    return p


def _project_qkv(p, x, cfg, pos):
    """q (B, S, H, hd), k and v (B, S, H_kv, hd): the heads of the
    weights given (a rank's slices under a mesh)."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(p["wq"], x).reshape(B, S, -1, hd)
    k = dense(p["wk"], x).reshape(B, S, -1, hd)
    v = dense(p["wv"], x).reshape(B, S, -1, hd)
    return (apply_rope(q, pos, cfg.rope_theta),
            apply_rope(k, pos, cfg.rope_theta), v)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, H_kv, hd) -> (B, S, H, hd) by GQA group broadcast."""
    B, S, Hkv, hd = k.shape
    rep = n_heads // Hkv
    if rep == 1:
        return k
    return k[:, :, :, None, :].expand(B, S, Hkv, rep, hd).reshape(
        B, S, n_heads, hd)


def _sdpa(q, k, v, cfg, causal: bool, window: int | None):
    """q, k, v: (B, S, H, hd) -> (B, Sq, H, hd), queries at the trailing
    positions; query-chunked on the plain route when Sq is long."""
    Sq, Sk = q.shape[1], k.shape[1]
    qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    chunk = cfg.attn_chunk
    if Sq <= chunk or (cfg.use_pallas and q.is_cuda):
        out = ops.attention(qT, kT, vT, causal=causal, window=window,
                            use_kernel=cfg.use_pallas)
    else:
        out = torch.cat([
            ref.mha_reference(qT[:, :, i:i + chunk], kT, vT, causal=causal,
                              window=window, q_offset=i + (Sk - Sq))
            for i in range(0, Sq, chunk)], dim=2)
    return out.transpose(1, 2)


def attention_block(p, x, cfg, *, pos=None, causal: bool = True,
                    window: int | None = None, mesh=None):
    """Full-sequence attention (train/prefill, the encoder with
    ``causal=False``).  x: (B, S, D); ``pos`` (S,) the rotary positions
    (default 0 ... S - 1); ``window`` None takes the config's; ``mesh``
    the model axis the weights are cut over.  Returns (out, KVCache of
    this sequence's k and v, this rank's heads)."""
    B, S, _ = x.shape
    if pos is None:
        pos = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, pos)
    win = window if window is not None else (cfg.sliding_window or None)
    H = q.shape[2]
    out = _sdpa(q, _expand_kv(k, H), _expand_kv(v, H), cfg, causal, win)
    out = out.reshape(B, S, H * cfg.hd)
    return row_dense(p["wo"], out, mesh), KVCache(k=k, v=v)


def decode_attention_block(p, x, cache: KVCache, cur_len: int, cfg,
                           window: int | None = None, mesh=None):
    """One-token decode against a cache.  x: (B, 1, D); cache.k/v:
    (B, S_max, H_kv, hd); ``cur_len`` valid history tokens; the new
    token's k and v (a quantized cache: their codes and scales) are
    written into the cache at index ``cur_len`` (in place: the same
    values as JAX's ``where``); a quantized cache is then attended
    dequantized to x's dtype; ``window`` masks the keys at or below
    cur_len - window (the caller passes the config's, as JAX's callers
    do).  Returns (out (B, 1, D), the cache)."""
    B = x.shape[0]
    hd = cfg.hd
    pos = torch.full((1,), cur_len, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos)
    if cache.quantized:
        for new, codes, scales in ((k_new, cache.k, cache.k_scale),
                                   (v_new, cache.v, cache.v_scale)):
            codes[:, cur_len], scales[:, cur_len] = quantize_kv(new[:, 0])
        k_all = dequantize_kv(cache.k, cache.k_scale, x.dtype)
        v_all = dequantize_kv(cache.v, cache.v_scale, x.dtype)
    else:
        cache.k[:, cur_len] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, cur_len] = v_new[:, 0].to(cache.v.dtype)
        k_all, v_all = cache.k, cache.v

    H, Hkv = q.shape[2], k_new.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_all.float()) / (hd ** 0.5)
    kpos = torch.arange(cache.k.shape[1], device=x.device)
    valid = kpos <= cur_len
    if window:
        valid &= kpos > cur_len - window
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    m = scores.amax(-1, keepdim=True)
    p_ = torch.exp(scores - m)
    denom = p_.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p_, v_all.float())
    out = (out / denom).reshape(B, 1, H * hd)
    return row_dense(p["wo"], out.to(x.dtype), mesh), cache


# ------------------------------ cross attention ------------------------------

def init_cross_attn(gen, cfg, dtype, lead=()):
    """Cross attention: queries from the stream, K/V from a memory of
    width d_model (JAX's ``kv_dim`` has no caller in either package); no
    bias, no rotary embedding."""
    D, hd = cfg.d_model, cfg.hd
    return {
        "wq": {"w": he_init(gen, (D, cfg.n_heads * hd), dtype, lead=lead)},
        "wk": {"w": he_init(gen, (D, cfg.n_kv_heads * hd), dtype,
                            lead=lead)},
        "wv": {"w": he_init(gen, (D, cfg.n_kv_heads * hd), dtype,
                            lead=lead)},
        "wo": {"w": he_init(gen, (cfg.n_heads * hd, D), dtype, lead=lead)},
    }


def cross_attention_block(p, x, memory, cfg, kv: KVCache | None = None):
    """x: (B, Sq, D); memory: (B, Sm, D), or None with ``kv`` the
    memory's K/V projected before (decode: the memory is static).  Not
    causal, no window.  Returns (out (B, Sq, D), KVCache over the
    memory)."""
    B, Sq, _ = x.shape
    hd = cfg.hd
    q = dense(p["wq"], x).reshape(B, Sq, cfg.n_heads, hd)
    if kv is None:
        Sm = memory.shape[1]
        kv = KVCache(
            k=dense(p["wk"], memory).reshape(B, Sm, cfg.n_kv_heads, hd),
            v=dense(p["wv"], memory).reshape(B, Sm, cfg.n_kv_heads, hd))
    out = _sdpa(q, _expand_kv(kv.k, cfg.n_heads),
                _expand_kv(kv.v, cfg.n_heads), cfg, causal=False,
                window=None)
    out = out.reshape(B, Sq, cfg.n_heads * hd)
    return dense(p["wo"], out), kv
