"""Decoder-only LMs (twin of the ``dense``, ``moe``, ``ssm`` (Mamba2 and
RWKV-6), ``hybrid`` (Zamba2) and ``vlm`` (llama-3.2-vision) families of
``src/repro/models/lm.py``).  An MoE block is the dense block with
``models/moe.py``'s layer in place of the MLP.  A hybrid model runs
``shared_attn_every`` Mamba2 layers, then the ONE shared attention + MLP
block, per group, and its tail layers after the last group.  A vlm runs
``cross_attn_every`` dense layers, then a gated cross-attention block
into the image patches (``batch["image_embed"]``, the stubbed vision
encoder's output), per group; each cross block's attention and MLP are
scaled by ``tanh`` of an f32 scalar gate, initialised to 0 as in JAX.

Layer parameters are stacked on a leading layer axis, as the JAX package's
``scan`` layout has them, so the per-layer compression rows and the wire
payload are the same; the forward walks the layers in a Python loop.  The
hybrid's ``blocks`` are stacked (groups, every, ...) and its ``tail``
(tail, ...), as JAX's are, so one compression row holds a whole group;
``shared`` is unstacked.  A vlm's ``blocks`` are (groups, every, ...)
and its ``cross`` (groups, ...), as JAX's are: one row a group; its
gates are ``(groups,)`` f32 leaves, which the bucket plan takes, as
JAX's does for any marked leaf of one axis, as one row of ``groups``
elements.

Three entry points per model: ``loss_fn`` (train), ``prefill`` (batched
context ingestion returning caches) and ``decode_step`` (one token
against the caches).  Caches are stacked on the layer axis like the
params (the hybrid's KV cache one slot a group, one per invocation of
the shared block).  ``decode_step`` writes the new token's KV entries,
the new RWKV states and the new Mamba2 conv windows and SSM states into
the cache it is given, in place, and returns it.

Every RMSNorm gets ``cfg.use_pallas``, so serving reaches the RMSNorm
kernel; the JAX package leaves the flag at its default (False) in every
call of its ``lm.py``, so its model never reaches its own kernel.

``prefill``, ``decode_step`` and ``init_cache`` take a ``mesh``
(:mod:`repro_torch.launch.mesh`) and ``params`` this rank's slices
(``sharding.shard_params``): the dense and MoE families run their layers
tensor-parallel over the model axis (``layers``, ``attention``, ``moe``)
with caches of this rank's kv heads; any family runs under a data axis
alone, on this rank's rows of the batch.  A leaf cut over ``data``
(``--params-2d``) is gathered whole just before its layer runs and
freed after it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.sharding import gather_data
from repro_torch.utils import tree_map, tree_map_with_path
from . import attention as attn
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .layers import (embed, init_embed, init_lm_head, init_mlp,
                     init_rms_norm, lm_head, mlp, rms_norm, softmax_xent)


def _is_rwkv(cfg) -> bool:
    return cfg.name.startswith("rwkv")


class DecodeCache(NamedTuple):
    """Stacked caches; the field a family does not use is ()."""
    kv: Any = ()          # attn.KVCache of (L, B, S_max, H_kv, hd) tensors
    ssm: Any = ()         # rwkv.RWKVState / ssm.SSMState of (L, ...) or,
    #                       hybrid, (groups, every, ...) tensors
    tail_ssm: Any = ()    # hybrid: ssm.SSMState of the (tail, ...) layers
    cross_kv: Any = ()    # encdec: attn.KVCache of the decoder layers' cross
    #                       K/V over the encoder output, (L, B, S_enc, H_kv,
    #                       hd); vlm: the cross blocks' K/V over the image
    #                       patches, (groups, B, n_patches, H_kv, hd)


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
    elif cfg.family == "ssm":
        params["blocks"] = _init_mamba_block(gen, cfg, dtype, L)
    elif cfg.family == "hybrid":
        groups, tail = _hybrid_depth(cfg)
        params["blocks"] = _init_mamba_block(
            gen, cfg, dtype, (groups, cfg.shared_attn_every))
        if tail:
            params["tail"] = _init_mamba_block(gen, cfg, dtype, (tail,))
        params["shared"] = {
            "attn_norm": init_rms_norm(cfg.d_model, dtype, dev),
            "attn": attn.init_attn(gen, cfg, dtype),
            "mlp_norm": init_rms_norm(cfg.d_model, dtype, dev),
            "mlp": init_mlp(gen, cfg, dtype),
        }
    elif cfg.family == "vlm":
        groups, every = _vlm_depth(cfg)
        params["blocks"] = _init_dense_block(gen, cfg, dtype, (groups, every))
        params["cross"] = _init_cross_block(gen, cfg, dtype, (groups,))
    else:
        params["blocks"] = _init_dense_block(gen, cfg, dtype, L)
    return tree_map(lambda x: x.to(device), params)


def _hybrid_depth(cfg) -> tuple[int, int]:
    """(groups, tail layers) of a hybrid model."""
    return divmod(cfg.n_layers, cfg.shared_attn_every)


def _vlm_depth(cfg) -> tuple[int, int]:
    """(groups, dense layers a group) of a vlm (the config checks that
    ``cross_attn_every`` divides ``n_layers``)."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every


def _init_dense_block(gen, cfg, dtype, lead):
    dev = gen.device
    blk = {"attn_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=lead),
           "attn": attn.init_attn(gen, cfg, dtype, lead=lead),
           "mlp_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=lead)}
    if cfg.family == "moe":
        blk["moe"] = moe_mod.init_moe(gen, cfg, dtype, lead=lead)
    else:
        blk["mlp"] = init_mlp(gen, cfg, dtype, lead=lead)
    return blk


def _init_cross_block(gen, cfg, dtype, lead):
    """A gated cross-attention block: the gates are f32 zeros whatever
    the parameter dtype, as JAX's are."""
    dev = gen.device
    return {"norm": init_rms_norm(cfg.d_model, dtype, dev, lead=lead),
            "cross": attn.init_cross_attn(gen, cfg, dtype, lead=lead),
            "mlp_norm": init_rms_norm(cfg.d_model, dtype, dev, lead=lead),
            "mlp": init_mlp(gen, cfg, dtype, lead=lead),
            "gate_attn": torch.zeros(lead, dtype=torch.float32, device=dev),
            "gate_mlp": torch.zeros(lead, dtype=torch.float32, device=dev)}


def _init_mamba_block(gen, cfg, dtype, lead):
    return {"norm": init_rms_norm(cfg.d_model, dtype, gen.device, lead=lead),
            "mamba": ssm_mod.init_mamba2(gen, cfg, dtype, lead=lead)}


def stacked_mask(params):
    """True for leaves with a leading layer axis (per-layer compression):
    every leaf under ``blocks`` (the MoE's ``(L, E, D, F)`` experts and
    ``(L, D, E)`` router included; a hybrid's or a vlm's ``(groups,
    every, ...)`` leaves, one row a group), under a vlm's ``cross`` (its
    ``(groups,)`` gates included, though a leaf of one axis is one row)
    and under a hybrid's ``tail``.  An encoder-decoder has none of these
    top keys."""
    return tree_map_with_path(
        lambda path, _: path[0] in ("blocks", "cross", "tail"), params)


def _layer(blocks, i):
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def _head(params, mesh=None):
    """The head's weights (the tied embedding's, transposed), gathered
    over ``data`` where cut there."""
    if "lm_head" in params:
        return gather_data(params["lm_head"], mesh)
    return {"w": gather_data(params["embed"], mesh)["w"].T}


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------

def _dense_block(p, x, cfg, mesh=None):
    """Pre-norm attention + SwiGLU MLP or MoE (with capacity drops).
    Returns (x, this layer's KV, the MoE's aux loss or None)."""
    h, kv = attn.attention_block(
        p["attn"], rms_norm(p["attn_norm"], x, cfg.norm_eps, cfg.use_pallas),
        cfg, mesh=mesh)
    x = x + h
    hn = rms_norm(p["mlp_norm"], x, cfg.norm_eps, cfg.use_pallas)
    if cfg.family == "moe":
        h2, aux = moe_mod.moe_block(p["moe"], hn, cfg, mesh=mesh)
        return x + h2, kv, aux
    return x + mlp(p["mlp"], hn, mesh), kv, None


def _dense_block_decode(p, x, kv, cur_len, cfg, mesh=None):
    h, _ = attn.decode_attention_block(
        p["attn"], rms_norm(p["attn_norm"], x, cfg.norm_eps, cfg.use_pallas),
        kv, cur_len, cfg, window=cfg.sliding_window or None, mesh=mesh)
    x = x + h
    hn = rms_norm(p["mlp_norm"], x, cfg.norm_eps, cfg.use_pallas)
    if cfg.family == "moe":
        return x + moe_mod.moe_block(p["moe"], hn, cfg, no_drop=True,
                                     mesh=mesh)[0]
    return x + mlp(p["mlp"], hn, mesh)


def _mamba_block(p, x, cfg, state=None, return_state=False):
    h, st = ssm_mod.mamba2_block(
        p["mamba"], rms_norm(p["norm"], x, cfg.norm_eps, cfg.use_pallas),
        cfg, state=state, return_state=return_state)
    return x + h, st


def _mamba_block_decode(p, x, state, cfg):
    h, st = ssm_mod.mamba2_decode(
        p["mamba"], rms_norm(p["norm"], x, cfg.norm_eps, cfg.use_pallas),
        state, cfg)
    return x + h, st


def _cross_block(p, x, memory, cfg, kv=None):
    """Gated cross attention into ``memory`` (or its projected K/V
    ``kv``), then a gated SwiGLU MLP; each gate is ``tanh`` of the f32
    scalar, cast to the stream's dtype before the product, as JAX orders
    it.  Returns (x, the K/V over the memory)."""
    h, kv = attn.cross_attention_block(
        p["cross"], rms_norm(p["norm"], x, cfg.norm_eps, cfg.use_pallas),
        memory, cfg, kv=kv)
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h
    h2 = mlp(p["mlp"], rms_norm(p["mlp_norm"], x, cfg.norm_eps,
                                cfg.use_pallas))
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * h2, kv


def _rwkv_block(p, x, cfg, state: rwkv_mod.RWKVState):
    h, state = rwkv_mod.time_mix(
        p["rwkv"], rms_norm(p["norm1"], x, cfg.norm_eps, cfg.use_pallas),
        cfg, state)
    x = x + h
    h, state = rwkv_mod.channel_mix(
        p["rwkv"], rms_norm(p["norm2"], x, cfg.norm_eps, cfg.use_pallas),
        state)
    return x + h, state


def _layers(params, cfg):
    """``(kind, layer params, cache field, index)`` in forward order: kind
    "dense" (a dense or MoE layer, the hybrid's shared block after group
    g, or a vlm's layer (g, e); its slot of ``cache.kv``), "rwkv" or
    "mamba" (its state in ``cache.ssm`` at an int or a hybrid's (group,
    layer), or a hybrid tail layer's in ``cache.tail_ssm``), "cross" (a
    vlm's cross block after group g; its slot of ``cache.cross_kv``)."""
    if cfg.family == "vlm":
        groups, every = _vlm_depth(cfg)
        for g in range(groups):
            for e in range(every):
                yield "dense", _layer(params["blocks"], (g, e)), "kv", (g, e)
            yield "cross", _layer(params["cross"], g), "cross_kv", g
        return
    if cfg.family == "hybrid":
        groups, tail = _hybrid_depth(cfg)
        for g in range(groups):
            for e in range(cfg.shared_attn_every):
                yield "mamba", _layer(params["blocks"], (g, e)), "ssm", (g, e)
            yield "dense", params["shared"], "kv", g
        for t in range(tail):
            yield "mamba", _layer(params["tail"], t), "tail_ssm", t
        return
    kind, field = ("rwkv", "ssm") if _is_rwkv(cfg) else \
        ("mamba", "ssm") if cfg.family == "ssm" else ("dense", "kv")
    for i in range(cfg.n_layers):
        yield kind, _layer(params["blocks"], i), field, i


def _put(stacked, i, new) -> None:
    """Write a layer's new state tuple into the stacked one, in place."""
    for s, n in zip(stacked, new):
        s[i] = n


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _units(params, cfg):
    """The layers of :func:`_layers` in the units JAX's ``jax.checkpoint``
    wraps under ``cfg.remat``: ``(wrapped, [layers])``.  A unit is one
    layer (dense, MoE, RWKV, Mamba2), or a group: a hybrid's
    ``shared_attn_every`` Mamba2 layers and the shared block, a vlm's
    ``cross_attn_every`` dense layers and the cross block.  A hybrid's
    tail layers are not wrapped, as JAX's tail scan is not."""
    layers = list(_layers(params, cfg))
    every = (cfg.shared_attn_every if cfg.family == "hybrid" else
             cfg.cross_attn_every if cfg.family == "vlm" else 0)
    if not every:
        return [(True, [layer]) for layer in layers]
    n = every + 1
    groups = cfg.n_layers // every
    return [(True, layers[g * n:(g + 1) * n]) for g in range(groups)] + \
        [(False, [layer]) for layer in layers[groups * n:]]


def remat(cfg, fn, *args):
    """``fn(*args)``, rematerialised in the backward pass when
    ``cfg.remat`` is set and autograd records (not under ``no_grad`` or
    ``inference_mode``: the Armijo trials and serving): its activations
    are recomputed from ``args`` instead of kept.  The forward draws no
    random numbers, so no RNG state is kept either."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _train_unit(layers, memory, cfg):
    """The training forward of one unit's layers: (x, aux) -> (x, aux),
    each MoE layer's aux loss added in layer order."""
    def run(x, aux):
        for kind, lp, _, _ in layers:
            if kind == "cross":
                x, _ = _cross_block(lp, x, memory, cfg)
            elif kind == "rwkv":
                x, _ = _rwkv_block(lp, x, cfg, rwkv_mod.init_rwkv_state(
                    cfg, x.shape[0], x.device))
            elif kind == "mamba":
                x, _ = _mamba_block(lp, x, cfg)
            else:
                x, _, a = _dense_block(lp, x, cfg)
                if a is not None:
                    aux = aux + a
        return x, aux
    return run


def loss_fn(params, batch: dict, cfg) -> torch.Tensor:
    """Next-token cross-entropy plus the MoE layers' aux losses, summed in
    layer order from an f32 zero (0 without MoE layers: the cross-entropy
    alone, bit for bit).  batch["tokens"]: (B, S) integers; a vlm's
    ``image_embed`` (B, n_patches, d_model), cast to the compute dtype.
    Under ``cfg.remat`` each of :func:`_units`' wrapped units is
    rematerialised (:func:`remat`): the same values, less memory."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = embed(params["embed"], inputs, cfg)
    memory = _image(batch, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for wrapped, layers in _units(params, cfg):
        run = _train_unit(layers, memory, cfg)
        x, aux = remat(cfg, run, x, aux) if wrapped else run(x, aux)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, cfg.use_pallas)
    ce = softmax_xent(lm_head(_head(params), x, cfg.vocab_size), targets)
    return ce + aux


def _image(batch: dict, x: torch.Tensor):
    """A vlm batch's patch embeddings in the stream's dtype (else None)."""
    image = batch.get("image_embed")
    return None if image is None else image.to(x.dtype)


# ---------------------------------------------------------------------------
# caches, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg, B: int, capacity: int, device="cpu",
               mesh=None) -> DecodeCache:
    """Zero caches with sequence capacity ``capacity`` (the KV cache and
    the Mamba2 conv windows in the compute dtype, the SSM states f32; a
    vlm's self K/V (groups, every, B, capacity, ...) and its cross K/V
    (groups, B, n_patches, ...)).  With ``kv_cache_dtype="int8"`` the
    self K/V are int8 codes with f32 scales (:func:`self_kv_cache`); the
    cross K/V stay in the compute dtype.  Under ``mesh`` the self K/V
    hold this rank's kv heads of the model axis."""
    if _is_rwkv(cfg):
        st = rwkv_mod.init_rwkv_state(cfg, B, device)
        return DecodeCache(ssm=rwkv_mod.RWKVState(*(
            x[None].repeat(cfg.n_layers, *([1] * x.dim())) for x in st)))
    dtype = getattr(torch, cfg.compute_dtype)

    def ssm_stack(*lead):
        st = ssm_mod.init_ssm_state(cfg, B, dtype, device)
        return ssm_mod.SSMState(*(torch.zeros(lead + tuple(x.shape),
                                              dtype=x.dtype, device=device)
                                  for x in st))

    def kv_stack(*lead, S=capacity, int8=cfg.kv_cache_dtype == "int8"):
        heads = cfg.n_kv_heads // (mesh.model_size if mesh is not None
                                     else 1)
        return self_kv_cache(lead + (B, S, heads, cfg.hd), dtype, int8,
                             device)

    if cfg.family == "ssm":
        return DecodeCache(ssm=ssm_stack(cfg.n_layers))
    if cfg.family == "hybrid":
        groups, tail = _hybrid_depth(cfg)
        return DecodeCache(kv=kv_stack(groups),
                           ssm=ssm_stack(groups, cfg.shared_attn_every),
                           tail_ssm=ssm_stack(tail) if tail else ())
    if cfg.family == "vlm":
        groups, every = _vlm_depth(cfg)
        return DecodeCache(kv=kv_stack(groups, every),
                           cross_kv=kv_stack(groups, S=cfg.n_patches,
                                             int8=False))
    return DecodeCache(kv=kv_stack(cfg.n_layers))


def self_kv_cache(shape, dtype, int8: bool, device) -> attn.KVCache:
    """A zero K/V cache of ``shape`` (..., B, S, H_kv, hd): in ``dtype``,
    or int8 codes with zero f32 scales (..., B, S, H_kv, 1), as JAX's
    zero-padded prefill leaves the positions past the prompt."""
    if not int8:
        return attn.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device))
    codes = [torch.zeros(shape, dtype=torch.int8, device=device)
             for _ in range(2)]
    scales = [torch.zeros(tuple(shape[:-1]) + (1,), dtype=torch.float32,
                          device=device) for _ in range(2)]
    return attn.KVCache(*codes, *scales)


def store_prefill_kv(cache: attn.KVCache, i, kv: attn.KVCache, cfg) -> None:
    """Write a layer's prefill K/V (B, S, H_kv, hd) into slot ``i`` of
    the stacked cache at positions 0 ... S - 1, quantized when the
    config asks for the int8 cache."""
    S = kv.k.shape[1]
    for dst, src in zip(cache.at(i), attn.maybe_quantize_cache(kv, cfg)):
        if isinstance(dst, torch.Tensor):
            dst[:, :S] = src


def prefill(params, batch: dict, cfg, capacity: int | None = None,
            mesh=None):
    """Ingest (B, S) context; return the last position's logits
    (B, 1, padded vocab) f32 and the caches, allocated at ``capacity``
    (default S) along the sequence; a vlm's cross K/V over its
    ``image_embed`` patches.  ``mesh``: see the module docstring."""
    if mesh is not None:
        cfg.check_mesh(mesh.model_size, mesh.data_size)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(gather_data(params["embed"], mesh), tokens, cfg, mesh)
    memory = _image(batch, x)
    cache = init_cache(cfg, B, capacity or S, device=x.device, mesh=mesh)
    for kind, lp, field, i in _layers(params, cfg):
        lp = gather_data(lp, mesh)
        if kind == "cross":
            x, kv = _cross_block(lp, x, memory, cfg)
            cache.cross_kv.k[i] = kv.k
            cache.cross_kv.v[i] = kv.v
        elif kind == "rwkv":
            x, st = _rwkv_block(lp, x, cfg, rwkv_mod.init_rwkv_state(
                cfg, B, x.device))
            _put(cache.ssm, i, st)
        elif kind == "mamba":
            x, st = _mamba_block(lp, x, cfg, return_state=True)
            _put(getattr(cache, field), i, st)
        else:
            x, kv, _ = _dense_block(lp, x, cfg, mesh)
            store_prefill_kv(cache.kv, i, kv, cfg)
    x = rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps,
                 cfg.use_pallas)
    return lm_head(_head(params, mesh), x, cfg.vocab_size, mesh), cache


def decode_step(params, token: torch.Tensor, cache: DecodeCache,
                cur_len: int, cfg, mesh=None):
    """One decode step.  token: (B, 1) integers; ``cur_len``: history
    length (the new token is written at cache index cur_len).  Updates
    ``cache`` in place; returns (logits (B, 1, padded vocab) f32, cache).
    A vlm's cross blocks take the cached K/V of prefill and no memory.
    ``mesh``: see the module docstring."""
    if mesh is not None:
        cfg.check_mesh(mesh.model_size, mesh.data_size)
    x = embed(gather_data(params["embed"], mesh), token, cfg, mesh)
    for kind, lp, field, i in _layers(params, cfg):
        lp = gather_data(lp, mesh)
        if kind == "cross":
            x, _ = _cross_block(lp, x, None, cfg, kv=cache.cross_kv.at(i))
        elif kind == "rwkv":
            x, st = _rwkv_block(lp, x, cfg, rwkv_mod.RWKVState(
                *(s[i] for s in cache.ssm)))
            _put(cache.ssm, i, st)
        elif kind == "mamba":
            stacked = getattr(cache, field)
            x, st = _mamba_block_decode(lp, x, ssm_mod.SSMState(
                *(s[i] for s in stacked)), cfg)
            _put(stacked, i, st)
        else:
            x = _dense_block_decode(lp, x, cache.kv.at(i), cur_len, cfg,
                                    mesh)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps, cfg.use_pallas)
    return lm_head(_head(params, mesh), x, cfg.vocab_size, mesh), cache
