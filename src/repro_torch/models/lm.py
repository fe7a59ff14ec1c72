"""Decoder-only dense LM (twin of the ``dense`` family of
``src/repro/models/lm.py``).

Layer parameters are stacked on a leading layer axis, as the JAX package's
``scan`` layout has them, so the per-layer compression rows and the wire
payload are the same; the forward walks the layers in a Python loop.
"""
from __future__ import annotations

import torch

from repro_torch.utils import tree_map, tree_map_with_path
from . import attention as attn
from .layers import (embed, init_embed, init_lm_head, init_mlp,
                     init_rms_norm, lm_head, mlp, rms_norm, softmax_xent)


def init_params(cfg, seed: int = 0, device="cpu"):
    """Random parameters from ``seed`` in the JAX package's tree layout.
    They are drawn on the CPU and then moved, so a seed gives the same
    weights on every device."""
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    L = (cfg.n_layers,)
    params = {
        "embed": init_embed(gen, cfg, dtype),
        "final_norm": init_rms_norm(cfg.d_model, dtype, cpu),
        "lm_head": init_lm_head(gen, cfg, dtype),
        "blocks": {
            "attn_norm": init_rms_norm(cfg.d_model, dtype, cpu, lead=L),
            "attn": attn.init_attn(gen, cfg, dtype, lead=L),
            "mlp_norm": init_rms_norm(cfg.d_model, dtype, cpu, lead=L),
            "mlp": init_mlp(gen, cfg, dtype, lead=L),
        },
    }
    return tree_map(lambda x: x.to(device), params)


def stacked_mask(params):
    """True for leaves with a leading layer axis (per-layer compression)."""
    return tree_map_with_path(lambda path, _: path[0] == "blocks", params)


def _layer(blocks, i):
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def _dense_block(p, x, cfg):
    x = x + attn.attention_block(p["attn"],
                                 rms_norm(p["attn_norm"], x, cfg.norm_eps),
                                 cfg)
    return x + mlp(p["mlp"], rms_norm(p["mlp_norm"], x, cfg.norm_eps))


def loss_fn(params, batch: dict, cfg) -> torch.Tensor:
    """Next-token cross-entropy.  batch["tokens"]: (B, S) integers."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = embed(params["embed"], inputs, cfg)
    for i in range(cfg.n_layers):
        x = _dense_block(_layer(params["blocks"], i), x, cfg)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return softmax_xent(lm_head(params["lm_head"], x, cfg.vocab_size),
                        targets)
