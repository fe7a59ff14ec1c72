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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops, ref
from .layers import apply_rope, dense, he_init


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S_max, H_kv, hd) in the compute dtype
    v: torch.Tensor      # (B, S_max, H_kv, hd)


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
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
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
                    window: int | None = None):
    """Full-sequence attention (train/prefill, the encoder with
    ``causal=False``).  x: (B, S, D); ``pos`` (S,) the rotary positions
    (default 0 ... S - 1); ``window`` None takes the config's.  Returns
    (out, KVCache of this sequence's k and v)."""
    B, S, _ = x.shape
    if pos is None:
        pos = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, pos)
    win = window if window is not None else (cfg.sliding_window or None)
    out = _sdpa(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                cfg, causal, win)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return dense(p["wo"], out), KVCache(k=k, v=v)


def decode_attention_block(p, x, cache: KVCache, cur_len: int, cfg,
                           window: int | None = None):
    """One-token decode against a cache.  x: (B, 1, D); cache.k/v:
    (B, S_max, H_kv, hd); ``cur_len`` valid history tokens; the new
    token's k and v are written into the cache at index ``cur_len`` (in
    place: the same values as JAX's ``where``); ``window`` masks the
    keys at or below cur_len - window (the caller passes the config's,
    as JAX's callers do).  Returns (out (B, 1, D), the cache)."""
    B = x.shape[0]
    hd = cfg.hd
    pos = torch.full((1,), cur_len, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos)
    cache.k[:, cur_len] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, cur_len] = v_new[:, 0].to(cache.v.dtype)

    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, cfg.n_kv_heads, G, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          cache.k.float()) / (hd ** 0.5)
    kpos = torch.arange(cache.k.shape[1], device=x.device)
    valid = kpos <= cur_len
    if window:
        valid &= kpos > cur_len - window
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    m = scores.amax(-1, keepdim=True)
    p_ = torch.exp(scores - m)
    denom = p_.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p_, cache.v.float())
    out = (out / denom).reshape(B, 1, cfg.n_heads * hd)
    return dense(p["wo"], out.to(x.dtype)), cache


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
