"""Decoder-only LMs (twin of the ``dense`` and ``moe`` families and the
RWKV-6 branch of the ``ssm`` family of ``src/repro/models/lm.py``).  An
MoE block is the dense block with ``models/moe.py``'s layer in place of
the MLP.

Layer parameters are stacked on a leading layer axis, as the JAX package's
``scan`` layout has them, so the per-layer compression rows and the wire
payload are the same; the forward walks the layers in a Python loop.

Three entry points per model: ``loss_fn`` (train), ``prefill`` (batched
context ingestion returning caches) and ``decode_step`` (one token
against the caches).  Caches are stacked on the layer axis like the
params.  ``decode_step`` writes the new token's KV entries and the new
RWKV states into the cache it is given, in place, and returns it.

Every RMSNorm gets ``cfg.use_pallas``, so serving reaches the RMSNorm
kernel; the JAX package leaves the flag at its default (False) in every
call of its ``lm.py``, so its model never reaches its own kernel.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils import tree_map, tree_map_with_path
from . import attention as attn
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from .layers import (embed, init_embed, init_lm_head, init_mlp,
                     init_rms_norm, lm_head, mlp, rms_norm, softmax_xent)


def _is_rwkv(cfg) -> bool:
    return cfg.name.startswith("rwkv")


class DecodeCache(NamedTuple):
    """Stacked caches; the field a family does not use is ()."""
    kv: Any = ()          # attn.KVCache of (L, B, S_max, H_kv, hd) tensors
    ssm: Any = ()         # rwkv.RWKVState of (L, ...) tensors


def init_params(cfg, seed: int = 0, device="cpu", draw_device="cpu"):
    """Random parameters from ``seed`` in the JAX package's tree layout
    (JAX's initialisers, torch's generator).  They are drawn on
    ``draw_device`` and then moved to ``device``: drawn on the CPU (the
    default) a seed gives the same weights on every device; a caller may
    draw full-width weights with the card's generator instead, which is
    faster but gives other weights than the CPU's."""
    gen = torch.Generator(device=draw_device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    dev = gen.device
    L = (cfg.n_layers,)
    params = {"embed": init_embed(gen, cfg, dtype),
              "final_norm": init_rms_norm(cfg.d_model, dtype, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_lm_head(gen, cfg, dtype)
    if _is_rwkv(cfg):
        params["blocks"] = {
            "norm1": init_rms_norm(cfg.d_model, dtype, dev, lead=L),
            "norm2": init_rms_norm(cfg.d_model, dtype, dev, lead=L),
            "rwkv": rwkv_mod.init_rwkv6(gen, cfg, dtype, lead=L),
        }
    else:
        params["blocks"] = {
            "attn_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=L),
            "attn": attn.init_attn(gen, cfg, dtype, lead=L),
            "mlp_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=L),
        }
        if cfg.family == "moe":
            params["blocks"]["moe"] = moe_mod.init_moe(gen, cfg, dtype,
                                                       lead=L)
        else:
            params["blocks"]["mlp"] = init_mlp(gen, cfg, dtype, lead=L)
    return tree_map(lambda x: x.to(device), params)


def stacked_mask(params):
    """True for leaves with a leading layer axis (per-layer compression):
    every leaf under ``blocks``, the MoE's ``(L, E, D, F)`` experts and
    ``(L, D, E)`` router included."""
    return tree_map_with_path(lambda path, _: path[0] == "blocks", params)


def _layer(blocks, i):
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def _head(params):
    return params.get("lm_head", {"w": params["embed"]["w"].T})


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------

def _dense_block(p, x, cfg):
    """Pre-norm attention + SwiGLU MLP or MoE (with capacity drops).
    Returns (x, this layer's KV, the MoE's aux loss or None)."""
    h, kv = attn.attention_block(
        p["attn"], rms_norm(p["attn_norm"], x, cfg.norm_eps, cfg.use_pallas),
        cfg)
    x = x + h
    hn = rms_norm(p["mlp_norm"], x, cfg.norm_eps, cfg.use_pallas)
    if cfg.family == "moe":
        h2, aux = moe_mod.moe_block(p["moe"], hn, cfg)
        return x + h2, kv, aux
    return x + mlp(p["mlp"], hn), kv, None


def _dense_block_decode(p, x, kv, cur_len, cfg):
    h, _ = attn.decode_attention_block(
        p["attn"], rms_norm(p["attn_norm"], x, cfg.norm_eps, cfg.use_pallas),
        kv, cur_len, cfg)
    x = x + h
    hn = rms_norm(p["mlp_norm"], x, cfg.norm_eps, cfg.use_pallas)
    if cfg.family == "moe":
        return x + moe_mod.moe_block(p["moe"], hn, cfg, no_drop=True)[0]
    return x + mlp(p["mlp"], hn)


def _rwkv_block(p, x, cfg, state: rwkv_mod.RWKVState):
    h, state = rwkv_mod.time_mix(
        p["rwkv"], rms_norm(p["norm1"], x, cfg.norm_eps, cfg.use_pallas),
        cfg, state)
    x = x + h
    h, state = rwkv_mod.channel_mix(
        p["rwkv"], rms_norm(p["norm2"], x, cfg.norm_eps, cfg.use_pallas),
        state)
    return x + h, state


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def loss_fn(params, batch: dict, cfg) -> torch.Tensor:
    """Next-token cross-entropy plus the MoE layers' aux losses, summed in
    layer order from an f32 zero (0 without MoE layers: the cross-entropy
    alone, bit for bit).  batch["tokens"]: (B, S) integers."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = embed(params["embed"], inputs, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        if _is_rwkv(cfg):
            x, _ = _rwkv_block(lp, x, cfg, rwkv_mod.init_rwkv_state(
                cfg, x.shape[0], x.device))
        else:
            x, _, a = _dense_block(lp, x, cfg)
            if a is not None:
                aux = aux + a
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, cfg.use_pallas)
    ce = softmax_xent(lm_head(_head(params), x, cfg.vocab_size), targets)
    return ce + aux


# ---------------------------------------------------------------------------
# caches, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg, B: int, capacity: int, device="cpu") -> DecodeCache:
    """Zero caches with sequence capacity ``capacity`` (the KV cache in
    the compute dtype)."""
    if _is_rwkv(cfg):
        st = rwkv_mod.init_rwkv_state(cfg, B, device)
        return DecodeCache(ssm=rwkv_mod.RWKVState(*(
            x[None].repeat(cfg.n_layers, *([1] * x.dim())) for x in st)))
    dtype = getattr(torch, cfg.compute_dtype)
    shape = (cfg.n_layers, B, capacity, cfg.n_kv_heads, cfg.hd)
    return DecodeCache(kv=attn.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device)))


def prefill(params, batch: dict, cfg, capacity: int | None = None):
    """Ingest (B, S) context; return the last position's logits
    (B, 1, padded vocab) f32 and the caches, allocated at ``capacity``
    (default S) along the sequence."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens, cfg)
    cache = init_cache(cfg, B, capacity or S, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        if _is_rwkv(cfg):
            x, st = _rwkv_block(lp, x, cfg, rwkv_mod.init_rwkv_state(
                cfg, B, x.device))
            for stacked, new in zip(cache.ssm, st):
                stacked[i] = new
        else:
            x, kv, _ = _dense_block(lp, x, cfg)
            cache.kv.k[i, :, :S] = kv.k
            cache.kv.v[i, :, :S] = kv.v
    x = rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps,
                 cfg.use_pallas)
    return lm_head(_head(params), x, cfg.vocab_size), cache


def decode_step(params, token: torch.Tensor, cache: DecodeCache,
                cur_len: int, cfg):
    """One decode step.  token: (B, 1) integers; ``cur_len``: history
    length (the new token is written at cache index cur_len).  Updates
    ``cache`` in place; returns (logits (B, 1, padded vocab) f32, cache)."""
    x = embed(params["embed"], token, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        if _is_rwkv(cfg):
            x, st = _rwkv_block(lp, x, cfg, rwkv_mod.RWKVState(
                *(s[i] for s in cache.ssm)))
            for stacked, new in zip(cache.ssm, st):
                stacked[i] = new
        else:
            x = _dense_block_decode(lp, x, attn.KVCache(
                cache.kv.k[i], cache.kv.v[i]), cur_len, cfg)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, cfg.use_pallas)
    return lm_head(_head(params), x, cfg.vocab_size), cache
