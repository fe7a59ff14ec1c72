"""Mixture-of-Experts layer (twin of ``src/repro/models/moe.py``, the path
JAX takes off a mesh): top-k token-choice routing, capacity buffers and
the experts' batched products.

Routing is sort-based, as in JAX: tokens are replicated k ways, sorted
by expert id and written into an ``(E, C, D)`` capacity buffer, which the
experts' batched products consume.  Overflow beyond the capacity
``C = ceil(T*k/E) * capacity_factor`` is dropped.

Where the port must choose an order, it takes JAX's:

* the top-k is a stable descending sort of the probabilities, so among
  equal probabilities the lower expert id comes first, as
  ``jax.lax.top_k`` puts it (``torch.topk`` promises no order);
* the dispatch sort is stable, so tokens compete for an expert's slots
  in token order;
* the combine adds a token's k contributions one after another in
  ascending expert id from a zero row, the order of JAX's
  ``y.at[st].add(...)`` over the sorted slots.  No atomics: two runs on
  the card give the same bits.

JAX's expert-parallel shard_map (``_maybe_expert_parallel``,
``_moe_local``) runs only under a ``model`` mesh axis and is not ported
(``ModelConfig`` refuses ``moe_expert_parallel=True``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F_

from .layers import he_init


class Route(NamedTuple):
    """One routing decision over T = B*S tokens, in JAX's names."""
    probs: torch.Tensor      # (T, E) f32 router softmax
    gate: torch.Tensor       # (T, k) normalised gate values, f32
    eids: torch.Tensor       # (T, k) expert ids, by descending probability
    C: int                   # slots per expert
    order: torch.Tensor      # (T*k,) the stable sort of the flat expert ids
    se: torch.Tensor         # (T*k,) expert id of each sorted slot
    sg: torch.Tensor         # (T*k,) its gate value
    st: torch.Tensor         # (T*k,) its token
    pos: torch.Tensor        # (T*k,) its position among the expert's slots
    keep: torch.Tensor       # (T*k,) pos < C
    aux: torch.Tensor        # () f32 load-balance loss


def init_moe(gen, cfg, dtype, lead=()):
    """The router (f32) and the experts' SwiGLU weights.  The experts'
    ``(E, D, F)`` weights take JAX's ``fan_in = shape[0]``, which is E."""
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": {"w": he_init(gen, (D, E), torch.float32, lead=lead)},
        "wg": he_init(gen, (E, D, F), dtype, lead=lead),
        "wi": he_init(gen, (E, D, F), dtype, lead=lead),
        "wo": he_init(gen, (E, F, D), dtype, lead=lead),
    }


def _reciprocal(n: int) -> float:
    """f32(1/n): jitted XLA turns a mean over a static n into a product
    with it."""
    return float(np.float32(1.0) / np.float32(n))


def balance_loss(probs: torch.Tensor, top1: torch.Tensor, coef: float):
    """The Switch-style load-balance loss of router ``probs`` (T, E) and
    each token's first expert ``top1`` (T,): sum(density * mean probs) *
    E * coef, the means as products with f32(1/T)."""
    T, E = probs.shape
    density = F_.one_hot(top1, E).float().sum(0) * _reciprocal(T)
    proxy = probs.sum(0) * _reciprocal(T)
    return (density * proxy).sum() * float(E) * float(np.float32(coef))


def route(p, xt: torch.Tensor, cfg, no_drop: bool = False) -> Route:
    """The router, the top-k, the aux loss and the dispatch sort for
    tokens ``xt`` (T, D)."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = xt.float() @ p["router"]["w"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eids = vals[:, :k], idx[:, :k]
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)

    aux = balance_loss(probs, eids[:, 0], cfg.router_aux_coef)

    # JAX's C: a host int from the static shapes, so no device sync
    C = T if no_drop else min(T, max(1, int(-(-T * k // E)
                                            * cfg.capacity_factor)))
    flat_e = eids.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    sg = gate.reshape(-1)[order]
    st = torch.div(order, k, rounding_mode="floor")             # token id
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=xt.device) - starts[se]
    return Route(probs, gate, eids, C, order, se, sg, st, pos, pos < C,
                 aux)


def moe_block(p, x: torch.Tensor, cfg, no_drop: bool = False):
    """x: (B, S, D) -> (y, aux).  ``no_drop=True`` (decode) sets C = T, so
    no token is dropped."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(T, D)
    r = route(p, xt, cfg, no_drop)
    C = r.C

    # dispatch: the kept slots into (E, C, D); a dropped one goes to the
    # spare row E*C, which is cut off (JAX adds +0.0 at slot C - 1)
    slot = torch.where(r.keep, r.se * C + r.pos,
                       torch.full_like(r.pos, E * C))
    buf = xt.new_zeros((E * C + 1, D)).index_put((slot,), xt[r.st])
    buf = buf[:E * C].view(E, C, D)

    h = F_.silu(torch.bmm(buf, p["wg"].to(buf.dtype))) \
        * torch.bmm(buf, p["wi"].to(buf.dtype))
    out = torch.bmm(h, p["wo"].to(buf.dtype)).view(E * C, D)

    # combine: out_buf[se, pos_c] * where(keep, sg, 0), each token's k
    # slots in sorted order (ascending expert id), added one after
    # another from a zero row, as JAX's scatter-add applies them
    src = r.se * C + r.pos.clamp(max=C - 1)
    w = torch.where(r.keep, r.sg, torch.zeros_like(r.sg)).to(out.dtype)
    inv = torch.empty_like(r.order)
    inv[r.order] = torch.arange(T * k, device=x.device)
    by_expert = torch.sort(inv.view(T, k), dim=-1).values     # (T, k)
    contrib = out[src[by_expert]] * w[by_expert][..., None]   # (T, k, D)
    y = torch.zeros((T, D), dtype=out.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y.view(B, S, D), r.aux
