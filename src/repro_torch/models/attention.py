"""Attention for training (twin of ``src/repro/models/attention.py``):
GQA with rotary embeddings and causal softmax attention written as plain
matmuls (the JAX package's ``ref`` attention path; no fused attention
call)."""
from __future__ import annotations

import torch

from .layers import apply_rope, dense, he_init


def init_attn(gen, cfg, dtype, lead=()):
    D, hd = cfg.d_model, cfg.hd
    return {
        "wq": {"w": he_init(gen, (D, cfg.n_heads * hd), dtype, lead=lead)},
        "wk": {"w": he_init(gen, (D, cfg.n_kv_heads * hd), dtype,
                            lead=lead)},
        "wv": {"w": he_init(gen, (D, cfg.n_kv_heads * hd), dtype,
                            lead=lead)},
        "wo": {"w": he_init(gen, (cfg.n_heads * hd, D), dtype, lead=lead)},
    }


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, H_kv, hd) -> (B, S, H, hd) by GQA group broadcast."""
    B, S, Hkv, hd = k.shape
    rep = n_heads // Hkv
    if rep == 1:
        return k
    return k[:, :, :, None, :].expand(B, S, Hkv, rep, hd).reshape(
        B, S, n_heads, hd)


def mha_reference(q, k, v):
    """Causal attention.  q: (B, H, Sq, D); k, v: (B, H, Sk, D); queries at
    offset Sk - Sq.  Softmax in f32; returns q.dtype."""
    Sq, D = q.shape[-2:]
    Sk = k.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (1.0 / D ** 0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    logits = torch.where(kpos <= qpos, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_block(p, x, cfg):
    """Full-sequence causal attention (train).  x: (B, S, D)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    hd = cfg.hd
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k, v = _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads)
    out = mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2))
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * hd)
    return dense(p["wo"], out)
