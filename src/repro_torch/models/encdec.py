"""Encoder-decoder transformer (twin of ``src/repro/models/encdec.py``, the
seamless-m4t backbone).

The audio frontend (mel + conv feature extractor) is stubbed, as in the
JAX package: the encoder takes precomputed frame embeddings
``batch["src_embed"]: (B, S_enc, d_model)``.  The encoder's self
attention is not causal; the text decoder is a causal transformer with,
in every layer, cross attention into the encoder's output.  With
``cfg.sliding_window`` both self attentions take JAX's one-sided window
``kpos > qpos - w`` and the cross attention none.

Layer parameters are stacked on a leading layer axis (``enc_blocks``
(n_enc_layers, ...), ``dec_blocks`` (n_dec_layers, ...)), as JAX's
``scan`` layout has them; the forward walks the layers in a Python loop.
JAX's ``stacked_mask`` (``lm.stacked_mask``) marks none of these leaves,
so the trainer compresses each stacked leaf as ONE row, not one row a
layer, as JAX's does.

Three entry points: ``loss_fn`` (train), ``prefill`` (encode the
source, ingest the decoder's context; the self K/V into caches of
``capacity``, the cross K/V of every layer once) and ``decode_step``
(one token against the self cache and the cross K/V).  ``decode_step``
writes the new token's self K/V into the cache it is given, in place,
and returns it.  Every RMSNorm gets ``cfg.use_pallas``, as in ``lm.py``,
so serving reaches the RMSNorm kernel.  ``prefill`` and ``decode_step``
take a ``mesh`` with a model axis of 1 (the family is not cut over the
model axis yet): each rank serves its rows, and a leaf cut over
``data`` (``--params-2d``) is gathered just before its layer runs.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import gather_data
from repro_torch.utils import tree_map
from . import attention as attn
from .layers import (embed, init_embed, init_lm_head, init_mlp,
                     init_rms_norm, lm_head, mlp, rms_norm, softmax_xent)
from .lm import (DecodeCache, _layer, remat, self_kv_cache,
                 store_prefill_kv)


def _norm(p, x, cfg):
    return rms_norm(p, x, cfg.norm_eps, cfg.use_pallas)


def init_params(cfg, seed: int = 0, device="cpu", draw_device="cpu"):
    """Random parameters from ``seed`` in the JAX package's tree layout,
    drawn on ``draw_device`` and moved to ``device`` (as
    ``lm.init_params``)."""
    gen = torch.Generator(device=draw_device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    dev = gen.device
    E, L = (cfg.n_enc_layers,), (cfg.n_dec_layers,)
    params = {
        "embed": init_embed(gen, cfg, dtype),
        "enc_blocks": {
            "attn_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=E),
            "attn": attn.init_attn(gen, cfg, dtype, lead=E),
            "mlp_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=E),
            "mlp": init_mlp(gen, cfg, dtype, lead=E),
        },
        "enc_norm": init_rms_norm(cfg.d_model, dtype, dev),
        "dec_blocks": {
            "self_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=L),
            "self_attn": attn.init_attn(gen, cfg, dtype, lead=L),
            "cross_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=L),
            "cross": attn.init_cross_attn(gen, cfg, dtype, lead=L),
            "mlp_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=L),
            "mlp": init_mlp(gen, cfg, dtype, lead=L),
        },
        "final_norm": init_rms_norm(cfg.d_model, dtype, dev),
        "lm_head": init_lm_head(gen, cfg, dtype),
    }
    return tree_map(lambda x: x.to(device), params)


def encode(params, src_embed: torch.Tensor, cfg,
           window: int | None = None, mesh=None) -> torch.Tensor:
    """src_embed: (B, S_enc, D) -> encoder memory (B, S_enc, D) in the
    compute dtype."""
    x = src_embed.to(getattr(torch, cfg.compute_dtype))
    for i in range(cfg.n_enc_layers):
        x = remat(cfg, _enc_block,
                  gather_data(_layer(params["enc_blocks"], i), mesh), x, cfg,
                  window)
    return _norm(params["enc_norm"], x, cfg)


def _enc_block(lp, x, cfg, window):
    """One encoder layer: self attention without causality, SwiGLU MLP."""
    a, _ = attn.attention_block(lp["attn"], _norm(lp["attn_norm"], x, cfg),
                                cfg, causal=False, window=window)
    x = x + a
    return x + mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg))


def _dec_block(lp, x, memory, cfg, window=None, kv_cross=None):
    """One decoder layer: causal self attention, cross attention into
    ``memory`` (or its K/V ``kv_cross``), SwiGLU MLP.  Returns (x, the
    self K/V, the cross K/V)."""
    a, kv_self = attn.attention_block(
        lp["self_attn"], _norm(lp["self_norm"], x, cfg), cfg, causal=True,
        window=window)
    x = x + a
    c, kv_cross = attn.cross_attention_block(
        lp["cross"], _norm(lp["cross_norm"], x, cfg), memory, cfg,
        kv=kv_cross)
    x = x + c
    x = x + mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg))
    return x, kv_self, kv_cross


def loss_fn(params, batch: dict, cfg) -> torch.Tensor:
    """Next-token cross-entropy of the decoder (no aux loss).  batch:
    ``src_embed`` (B, S_enc, D) and ``tokens`` (B, S_dec) integers; the
    decoder reads ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``."""
    window = cfg.sliding_window or None
    memory = encode(params, batch["src_embed"], cfg, window=window)
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = embed(params["embed"], inputs, cfg).to(memory.dtype)
    for i in range(cfg.n_dec_layers):
        x = remat(cfg, lambda lp, h: _dec_block(lp, h, memory, cfg,
                                                window=window)[0],
                  _layer(params["dec_blocks"], i), x)
    x = _norm(params["final_norm"], x, cfg)
    return softmax_xent(lm_head(params["lm_head"], x, cfg.vocab_size),
                        targets)


def init_cache(cfg, B: int, capacity: int, s_enc: int,
               device="cpu") -> DecodeCache:
    """Zero caches in the compute dtype: the decoder's self K/V at
    sequence capacity ``capacity`` (int8 codes with f32 scales with
    ``kv_cache_dtype="int8"``) and its cross K/V over ``s_enc`` encoder
    frames."""
    dtype = getattr(torch, cfg.compute_dtype)

    def kv(S, int8=False):
        return self_kv_cache((cfg.n_dec_layers, B, S, cfg.n_kv_heads,
                              cfg.hd), dtype, int8, device)
    return DecodeCache(kv=kv(capacity, cfg.kv_cache_dtype == "int8"),
                       cross_kv=kv(s_enc))


def prefill(params, batch: dict, cfg, capacity: int | None = None,
            mesh=None):
    """Encode the source and ingest the (B, S) decoder context; return
    the last position's logits (B, 1, padded vocab) f32 and the caches
    (the self K/V allocated at ``capacity``, default S)."""
    if mesh is not None:
        cfg.check_mesh(mesh.model_size, mesh.data_size)
    window = cfg.sliding_window or None
    memory = encode(params, batch["src_embed"], cfg, window=window,
                    mesh=mesh)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(gather_data(params["embed"], mesh), tokens, cfg).to(
        memory.dtype)
    cache = init_cache(cfg, B, capacity or S, memory.shape[1],
                       device=x.device)
    for i in range(cfg.n_dec_layers):
        x, kv_self, kv_cross = _dec_block(
            gather_data(_layer(params["dec_blocks"], i), mesh), x, memory,
            cfg, window=window)
        store_prefill_kv(cache.kv, i, kv_self, cfg)
        cache.cross_kv.k[i] = kv_cross.k
        cache.cross_kv.v[i] = kv_cross.v
    x = _norm(params["final_norm"], x[:, -1:], cfg)
    return lm_head(gather_data(params["lm_head"], mesh), x,
                   cfg.vocab_size), cache


def decode_step(params, token: torch.Tensor, cache: DecodeCache,
                cur_len: int, cfg, window: int | None = None, mesh=None):
    """One decoder token against (the self cache, the cross K/V of
    prefill).  token: (B, 1) integers; the new token's self K/V are
    written at index ``cur_len``, in place.  Returns (logits (B, 1,
    padded vocab) f32, cache)."""
    if mesh is not None:
        cfg.check_mesh(mesh.model_size, mesh.data_size)
    window = window or (cfg.sliding_window or None)
    x = embed(gather_data(params["embed"], mesh), token, cfg)
    for i in range(cfg.n_dec_layers):
        lp = gather_data(_layer(params["dec_blocks"], i), mesh)
        a, _ = attn.decode_attention_block(
            lp["self_attn"], _norm(lp["self_norm"], x, cfg),
            cache.kv.at(i), cur_len, cfg, window=window)
        x = x + a
        c, _ = attn.cross_attention_block(
            lp["cross"], _norm(lp["cross_norm"], x, cfg), None, cfg,
            kv=cache.cross_kv.at(i))
        x = x + c
        x = x + mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg))
    x = _norm(params["final_norm"], x, cfg)
    return lm_head(gather_data(params["lm_head"], mesh), x,
                   cfg.vocab_size), cache
