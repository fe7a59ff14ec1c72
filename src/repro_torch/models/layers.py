"""Basic layers (twin of ``src/repro/models/layers.py``): init helpers,
RMSNorm, rotary embeddings, SwiGLU MLP, embeddings, LM head and the
cross-entropy.  Functional: params are nested dicts of tensors in the JAX
package's layout; each function takes ``(params, x, ...)``.  Params may
be bf16: each product casts the weight to the activation's type, as the
JAX package does.

Under a mesh (``mesh``, :mod:`repro_torch.launch.mesh`) each function
takes this rank's slices of the weights that ``sharding.leaf_pspec``
cuts over the model axis, as JAX's ``hint(..., TP)`` marks them: a
column-parallel product (``wq``, ``wk``, ``wv``, ``wg``, ``wi``) gives
its slice of the output with no collective; a row-parallel one (``wo``)
gives a partial sum, added over the model axis (``sharding.tp_sum``)
before a bias; the embedding gathers its d_model slices, the head its
vocab slices.  Norm weights and the residual stream stay whole on every
rank.  ``mesh=None`` (or a model axis of 1) is the one-device path."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F_

from repro_torch.kernels import ops
from repro_torch.sharding import tp_gather, tp_sum


def he_init(gen: torch.Generator, shape, dtype, fan_in=None, lead=()):
    """normal / sqrt(fan_in); ``lead`` prepends stacked layer axes."""
    fan_in = fan_in or shape[0]
    x = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    device=gen.device) / math.sqrt(fan_in)
    return x.to(dtype)


def dense(p, x):
    """x @ w (+ b)."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def row_dense(p, x, mesh=None):
    """A row-parallel x @ w: the model axis's partial products summed,
    then the bias (replicated by the rules) added once."""
    y = tp_sum(x @ p["w"].to(x.dtype), mesh)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rms_norm(p, x, eps: float, use_pallas: bool = False):
    """x * rsqrt(mean(x^2) + eps) * w, f32 accumulation; ``use_pallas``
    takes the RMSNorm kernel for a CUDA tensor."""
    return ops.rms_norm(x, p["w"], eps=eps, use_kernel=use_pallas)


def init_rms_norm(d, dtype, device, lead=()):
    return {"w": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)}


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x: (B, S, H, hd); pos: (S,) absolute positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = (pos[:, None].float() * freqs[None, :])[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, cfg, dtype, lead=()):
    return {"wg": he_init(gen, (cfg.d_model, cfg.d_ff), dtype, lead=lead),
            "wi": he_init(gen, (cfg.d_model, cfg.d_ff), dtype, lead=lead),
            "wo": he_init(gen, (cfg.d_ff, cfg.d_model), dtype, lead=lead)}


def mlp(p, x, mesh=None):
    """SwiGLU; the hidden dim is the model axis's."""
    h = F_.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    return tp_sum(h @ p["wo"].to(x.dtype), mesh)


def init_embed(gen, cfg, dtype):
    return {"w": (torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                              device=gen.device) * 0.02).to(dtype)}


def embed(p, tokens, cfg, mesh=None):
    """The rows of ``tokens``; the table's d_model slices gathered."""
    return tp_gather(p["w"][tokens.long()], -1, mesh).to(
        getattr(torch, cfg.compute_dtype))


def init_lm_head(gen, cfg, dtype):
    return {"w": he_init(gen, (cfg.d_model, cfg.padded_vocab), dtype,
                         fan_in=cfg.d_model)}


def lm_head(p, x, true_vocab: int | None = None, mesh=None):
    """Logits in f32; padded vocab columns masked to -1e30 (after the
    gather: a slice boundary can fall inside the padding).  Under a mesh
    the head's vocab slices are gathered; a tied head (the embedding's
    table, transposed, cut on d_model) is row-parallel instead."""
    w = p["w"].to(x.dtype)
    if w.shape[0] == x.shape[-1]:
        logits = tp_gather((x @ w).float(), -1, mesh)
    else:
        x = x.narrow(-1, mesh.coord("model") * w.shape[0], w.shape[0])
        logits = tp_sum((x @ w).float(), mesh)
    V = logits.shape[-1]
    if true_vocab is not None and true_vocab < V:
        mask = torch.arange(V, device=logits.device) < true_vocab
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return logits


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - gold).mean()
