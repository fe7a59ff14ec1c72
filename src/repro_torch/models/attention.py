"""Attention (twin of ``src/repro/models/attention.py``): GQA with rotary
embeddings and QKV bias; full-sequence attention for training and
prefill, and one-token attention against a KV cache for decode.

Full-sequence attention takes one of two routes (``_sdpa``):

* ``cfg.use_pallas`` and CUDA tensors: the flash-attention kernel, ONE
  launch over the whole query length;
* otherwise the plain attention of :mod:`repro_torch.kernels.ref`, in
  query chunks of ``cfg.attn_chunk`` when the sequence is longer, as the
  JAX package's jnp path computes it (the chunks only bound the (Sq, Sk)
  logits the plain version holds).

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


def _sdpa(q, k, v, cfg):
    """Causal attention, q, k, v: (B, S, H, hd) -> (B, Sq, H, hd)."""
    Sq, Sk = q.shape[1], k.shape[1]
    qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    chunk, window = cfg.attn_chunk, cfg.sliding_window or None
    if Sq <= chunk or (cfg.use_pallas and q.is_cuda):
        out = ops.attention(qT, kT, vT, window=window,
                            use_kernel=cfg.use_pallas)
    else:
        out = torch.cat([
            ref.mha_reference(qT[:, :, i:i + chunk], kT, vT, window=window,
                              q_offset=i + (Sk - Sq))
            for i in range(0, Sq, chunk)], dim=2)
    return out.transpose(1, 2)


def attention_block(p, x, cfg):
    """Full-sequence causal attention (train/prefill).  x: (B, S, D).
    Returns (out, KVCache of this sequence's k and v)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, torch.arange(S, device=x.device))
    out = _sdpa(q, _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads),
                cfg)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return dense(p["wo"], out), KVCache(k=k, v=v)


def decode_attention_block(p, x, cache: KVCache, cur_len: int, cfg):
    """One-token decode against a cache.  x: (B, 1, D); cache.k/v:
    (B, S_max, H_kv, hd); ``cur_len`` valid history tokens; the new
    token's k and v are written into the cache at index ``cur_len`` (in
    place: the same values as JAX's ``where``).  Returns (out (B, 1, D),
    the cache)."""
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
    if cfg.sliding_window:
        valid &= kpos > cur_len - cfg.sliding_window
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    m = scores.amax(-1, keepdim=True)
    p_ = torch.exp(scores - m)
    denom = p_.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p_, cache.v.float())
    out = (out / denom).reshape(B, 1, cfg.n_heads * hd)
    return dense(p["wo"], out.to(x.dtype)), cache
