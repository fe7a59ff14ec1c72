"""Mixture-of-Experts layer (twin of ``src/repro/models/moe.py``): top-k
token-choice routing, capacity buffers and the experts' batched
products, on one device or with the experts cut over a mesh's model
axis.

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

:func:`moe_local` is the twin of JAX's ``_moe_local``: every rank routes
all of its tokens with the whole (replicated) router and dispatches only
to its E/M local experts, ids ``e_offset`` on; the slots of other
experts sort after them and add nothing.  :func:`moe_block` under a
mesh adds the ranks' partial (T, D) outputs over the model axis (one
``tp_sum``, JAX's ``psum``); off a mesh it is ``moe_local`` over all
experts.  Where a data axis splits the batch the capacity follows JAX
exactly:

* ``moe_expert_parallel=False``: JAX's partitioner computes the layer
  over the GLOBAL batch, so C and the drops depend on every data rank's
  tokens.  The port gathers the top-k expert ids ``(T_local, k)`` over
  the data ranks (ids only), sets C from the global token count and
  starts each expert's positions after the slots the earlier ranks'
  tokens hold;
* ``moe_expert_parallel=True``: JAX's shard_map manualizes the batch
  over the data axes, so each data rank routes its own T alone, as the
  port then does.

At decode ``no_drop`` sets C = T and the two agree.  The load-balance
loss under a mesh is over the rank's own tokens (serving drops it).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F_

from repro_torch.comm import exchange
from repro_torch.sharding import tp_sum
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
    #                          (after the earlier data ranks' slots)
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


def route(p, xt: torch.Tensor, cfg, no_drop: bool = False,
          data_group=None) -> Route:
    """The router, the top-k, the aux loss and the dispatch sort for
    tokens ``xt`` (T, D).  ``data_group``: the process group of the data
    ranks whose tokens, in rank order, make up the batch the capacity is
    set over (None: these tokens alone)."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = xt.float() @ p["router"]["w"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eids = vals[:, :k], idx[:, :k]
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)

    aux = balance_loss(probs, eids[:, 0], cfg.router_aux_coef)

    flat_e = eids.reshape(-1)                                   # (T*k,)
    n_tok, prior = T, None
    if data_group is not None and not no_drop:
        ids = exchange.all_gather_dim(eids, 0, data_group)     # (D*T, k)
        n_tok = ids.shape[0]
        prior = torch.bincount(
            ids[:dist.get_rank(data_group) * T].reshape(-1), minlength=E)
    # JAX's C: a host int from the static shapes, so no device sync
    C = n_tok if no_drop else min(n_tok, max(1, int(
        -(-n_tok * k // E) * cfg.capacity_factor)))
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    sg = gate.reshape(-1)[order]
    st = torch.div(order, k, rounding_mode="floor")             # token id
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=xt.device) - starts[se]
    if prior is not None:
        pos = pos + prior[se]
    return Route(probs, gate, eids, C, order, se, sg, st, pos, pos < C,
                 aux)


def moe_block(p, x: torch.Tensor, cfg, no_drop: bool = False, mesh=None):
    """x: (B, S, D) -> (y, aux).  ``no_drop=True`` (decode) sets C = T, so
    no token is dropped.  ``mesh``: the experts ``p["wg"]`` etc. are this
    rank's E/M slice of the model axis (see the module docstring for
    the data axis)."""
    e_off = mesh.coord("model") * p["wg"].shape[0] if mesh is not None \
        else 0
    group = mesh.dp_group if (mesh is not None and mesh.data_size > 1
                              and not cfg.moe_expert_parallel) else None
    y, aux = moe_local(x, p["router"]["w"], p["wg"], p["wi"], p["wo"], cfg,
                       e_off, no_drop, data_group=group)
    return tp_sum(y, mesh), aux


def moe_local(x, router_w, wg, wi, wo, cfg, e_offset: int = 0,
              no_drop: bool = False, data_group=None):
    """Routing, capacity dispatch and the SwiGLU experts for the LOCAL
    experts ``wg``/``wi``/``wo`` (E_loc, ...), ids ``e_offset`` ...
    ``e_offset + E_loc - 1`` (JAX's ``_moe_local``).  x: (B, S, D) ->
    (this rank's partial y (B, S, D), aux): the tokens' slots of other
    experts add nothing here.  ``data_group``: as :func:`route`."""
    B, S, D = x.shape
    T, k = B * S, cfg.experts_per_token
    E_loc = wg.shape[0]
    xt = x.reshape(T, D)
    r = route({"router": {"w": router_w}}, xt, cfg, no_drop, data_group)
    C = r.C
    if E_loc == cfg.n_experts:          # every expert here: no masking
        le = lc = r.se
        kept = r.keep
    else:
        le = r.se - e_offset                                    # local ids
        kept = r.keep & (le >= 0) & (le < E_loc)
        lc = le.clamp(0, E_loc - 1)

    # dispatch: the kept slots into (E_loc, C, D); a dropped or another
    # rank's one goes to the spare row E_loc*C, which is cut off (JAX
    # adds +0.0 at a clamped slot)
    slot = torch.where(kept, le * C + r.pos,
                       torch.full_like(r.pos, E_loc * C))
    buf = xt.new_zeros((E_loc * C + 1, D)).index_put((slot,), xt[r.st])
    buf = buf[:E_loc * C].view(E_loc, C, D)

    h = F_.silu(torch.bmm(buf, wg.to(buf.dtype))) \
        * torch.bmm(buf, wi.to(buf.dtype))
    out = torch.bmm(h, wo.to(buf.dtype)).view(E_loc * C, D)

    # combine: out_buf[se, pos_c] * where(keep, sg, 0), each token's k
    # slots in sorted order (ascending expert id), added one after
    # another from a zero row, as JAX's scatter-add applies them
    src = lc * C + r.pos.clamp(max=C - 1)
    w = torch.where(kept, r.sg, torch.zeros_like(r.sg)).to(out.dtype)
    inv = torch.empty_like(r.order)
    inv[r.order] = torch.arange(T * k, device=x.device)
    by_expert = torch.sort(inv.view(T, k), dim=-1).values     # (T, k)
    contrib = out[src[by_expert]] * w[by_expert][..., None]   # (T, k, D)
    y = torch.zeros((T, D), dtype=out.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y.view(B, S, D), r.aux
